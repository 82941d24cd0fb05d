"""Batch codec inference: ``Speech2Token`` (port of funcodec_tpu/cli/codec_inference.py).

One process drives one GPU, named by ``device`` (default "cuda"; pass "cpu"
to run on the CPU). The wav.scp -> codecs.txt
pipeline (``inference_pipeline``, the json/ark writers and ``main``) is
ROADMAP.md queue 1 item 10 and not ported yet.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from funcodec_tpu_torch.compat.from_jax import load_torch_state_dict
from funcodec_tpu_torch.tasks.codec import build_codec_model, load_config, resolve_device

_UNSET = object()
RUN_MODS = ("inference", "encode", "decode", "decode_emb")
INIT_SEED = 0  # random weights when no model file is given


class Speech2Token:
    """Codec model wrapper with run_mod in {inference, encode, decode, decode_emb}.

    `config_file` is a FunCodec config.yaml path or an already-loaded dict.
    `model_file` is a FunCodec .pth; without one the weights are random,
    drawn from a torch.Generator seeded with INIT_SEED. dtype "bfloat16" casts
    the parameters but not the codebooks (fp32 buffers, as in the JAX
    package); "float32" also turns off TF32 in cuDNN and cuBLAS, which would
    break the fp32 path's token exactness.
    """

    def __init__(
        self,
        config_file: Union[str, Mapping[str, Any]],
        model_file: Optional[str] = None,
        dtype: str = "float32",
        bit_width: Optional[int] = 8_000,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if isinstance(config_file, Mapping):
            self.config = dict(config_file)
        else:
            self.config = load_config(config_file)
        self.device = resolve_device(device)
        self.bit_width = bit_width
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        if self.dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        generator = torch.Generator(device=self.device).manual_seed(INIT_SEED)
        self.model, _ = build_codec_model(self.config, device=self.device, generator=generator)
        if model_file and os.path.exists(model_file):
            if not model_file.endswith((".pth", ".pt", ".bin")):
                raise NotImplementedError("only FunCodec .pth checkpoints load in the port")
            self.model.load_state_dict(load_torch_state_dict(model_file))
        else:
            logging.warning("no model file %s; random init (seed %d)", model_file, INIT_SEED)
        self.model.eval()
        if self.dtype == torch.bfloat16:
            # parameters only: the codebooks stay fp32 buffers. torch leaves
            # bf16 LSTM weights unflattened (cudnn.is_acceptable excludes
            # bf16), so cuDNN compacts them on each call and warns.
            with torch.no_grad():
                for p in self.model.parameters():
                    p.data = p.data.to(torch.bfloat16)

    @property
    def bits_per_quant(self) -> int:
        q = self.model.quantizer.cfg
        return (q.sampling_rate // q.encoder_hop_length) * int(math.log2(q.codebook_size))

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def dispatch(
        self,
        speech,
        need_recon: bool = True,
        bit_width=_UNSET,
        use_scale: bool = True,
        run_mod: str = "inference",
    ) -> Dict[str, Any]:
        """Run one batch and return the model's out dict of device tensors
        without copying to the host (CUDA work is queued asynchronously).

        speech: (B, T) waveform (float, or int16 PCM that is dequantized on
        the device), (B, T, n_q) tokens for decode, (B, T, D) embeddings for
        decode_emb; a numpy array or a tensor."""
        if run_mod not in RUN_MODS:
            raise ValueError(run_mod)
        if bit_width is _UNSET:
            bit_width = self.bit_width
        model = self.model
        with torch.inference_mode():
            if run_mod == "decode":
                nq = None
                if bit_width is not None:
                    nq = int(max(bit_width // self.bits_per_quant, 1))
                tokens = self._to_device(speech, torch.int64)[:, :, :nq]
                return model.inference_decoding(tokens)
            if run_mod == "decode_emb":
                return model.inference_decoding_emb(self._to_device(speech))
            x = self._to_device(speech)
            if x.dtype == torch.int16:
                x = x.float() * (1.0 / 32768.0)
            x = x.to(self.dtype)
            if run_mod == "inference":
                return model.inference(
                    x, need_recon=need_recon, bit_width=bit_width, use_scale=use_scale
                )
            return model.inference_encoding(
                x, need_recon=need_recon, bit_width=bit_width, use_scale=use_scale
            )

    @staticmethod
    def collect(out: Dict[str, Any], need_sub_quants: bool = True):
        """Copy a dispatched batch to the host: (code_indices [int32 (n_q, B, T)],
        code_embeddings (device tensors), recon float32 (B, T), sub_quants)."""
        codes = out.get("code_indices")
        if codes is not None and codes[0] is not None:
            codes = [c.cpu().numpy().astype(np.int32) for c in codes]
        r = out.get("recon_speech")
        recon = r.float().cpu().numpy() if r is not None else None
        sub_quants = out.get("sub_quants") if need_sub_quants else None
        if sub_quants is not None and sub_quants[0] is not None:
            sub_quants = [s.float().cpu().numpy() for s in sub_quants]
        return codes, out.get("code_embeddings"), recon, sub_quants

    def __call__(
        self,
        speech,
        need_recon: bool = True,
        bit_width=_UNSET,
        use_scale: bool = True,
        run_mod: str = "inference",
    ):
        """One synchronous batch. bit_width: omit for the constructor default;
        pass None explicitly for ALL quantizers."""
        return self.collect(
            self.dispatch(
                speech, need_recon=need_recon, bit_width=bit_width,
                use_scale=use_scale, run_mod=run_mod,
            )
        )


def _bucket_length(t: int, hop: int, quantum: int = 16) -> int:
    """Round T up so the token length is a multiple of `quantum` frames."""
    frames = -(-t // hop)
    frames = -(-frames // quantum) * quantum
    return frames * hop
