"""Dataset shape scanning and stats collection (port of funcodec_tpu/utils/shape_utils.py).

Behavioral reference: funcodec/utils/wav_utils.py (calc_shape :191-253:
a multi-worker wav-length scan with min/max filtering, generate_data_list
:254+) and funcodec/util_funcs/collect_stats.py:24 (--collect_stats: shape
files and the feature sum / square sum for CMVN). Host-side numpy work on
the port's data/wav_io; nothing here touches a device.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from funcodec_tpu_torch.data.wav_io import read_2column_text, read_wav


def wav_length(path: str) -> int:
    """Sample count of a wav file."""
    _sr, x = read_wav(path)
    return x.shape[0]


def calc_shape(
    data_dir: str,
    dataset: str,
    out_dir: str,
    min_length: Optional[int] = None,
    max_length: Optional[int] = None,
    num_workers: int = 8,
    scp_name: str = "wav.scp",
    shape_name: str = "speech_shape",
) -> Tuple[int, int]:
    """Scan wav lengths into `{out_dir}/{dataset}/{shape_name}` ('uttid
    length' lines, in the scp's order), dropping unreadable utterances and
    those outside [min_length, max_length]. Returns (kept, dropped)."""
    scp = read_2column_text(os.path.join(data_dir, dataset, scp_name))
    out_path = Path(out_dir) / dataset
    out_path.mkdir(parents=True, exist_ok=True)

    def job(item):
        key, path = item
        try:
            return key, wav_length(path)
        except Exception:
            return key, -1

    with ThreadPoolExecutor(num_workers) as pool:
        results = list(pool.map(job, scp.items()))

    kept = dropped = 0
    with open(out_path / shape_name, "w") as f:
        for key, length in results:
            if (length < 0 or (min_length is not None and length < min_length)
                    or (max_length is not None and length > max_length)):
                dropped += 1
                continue
            f.write(f"{key} {length}\n")
            kept += 1
    return kept, dropped


def generate_data_list(
    data_dir: str, dataset: str, out_name: str = "data.list", scp_name: str = "wav.scp"
) -> str:
    """wav.scp -> the jsonl data.list of the streaming loader
    (utils/wav_utils.py:254+, WeNet style). Returns its path."""
    scp = read_2column_text(os.path.join(data_dir, dataset, scp_name))
    out = os.path.join(data_dir, dataset, out_name)
    with open(out, "w") as f:
        for key, path in scp.items():
            f.write(json.dumps({"key": key, "wav": path}) + "\n")
    return out


def collect_stats(dataset, out_dir: str, feature_name: str = "speech") -> Dict[str, np.ndarray]:
    """--collect_stats (util_funcs/collect_stats.py:24): a per-utterance
    shape file and the global sum / square sum (float64) / frame count of
    `feature_name` for CMVN, also saved as `{feature_name}_stats.npz`."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    total = sq_total = None
    count = 0
    with open(out / f"{feature_name}_shape", "w") as f:
        for uid in dataset.uttids:
            _, data = dataset[uid]
            feat = np.asarray(data[feature_name])
            f.write(f"{uid} {','.join(str(s) for s in feat.shape)}\n")
            flat = feat.reshape(-1, feat.shape[-1]) if feat.ndim > 1 else feat[:, None]
            if total is None:
                total = flat.sum(axis=0).astype(np.float64)
                sq_total = (flat.astype(np.float64) ** 2).sum(axis=0)
            else:
                total += flat.sum(axis=0)
                sq_total += (flat.astype(np.float64) ** 2).sum(axis=0)
            count += flat.shape[0]
    stats = {"sum": total, "sq_sum": sq_total, "count": np.asarray(count)}
    np.savez(out / f"{feature_name}_stats.npz", **stats)
    return stats
