"""The numbers that decide ``correct`` for a codec that serves requests.

Each sampled request is judged on what the program returned (its tokens
and its PCM16 reconstruction) against the float32 reference computed on the
same input row (the wrap-padded row the batch carried):

- ``token_gap``: along the served tokens, for each frame and stage, how far
  the served codeword's score (2 r.e - ||e||^2 on the reference's residual,
  the residual following the served codewords) lies below the best
  codeword's, over the spread (standard deviation) of that stage's scores;
  the mean over the request's frames and stages. A near-tie that rounding
  flips costs almost nothing; a codeword far from the best costs much.
- ``recon_err``: relative L2 distance of the served PCM16 from the
  reference's decode of the served tokens, over the valid samples.

The run's number is the worst sampled request's. ``q0_flip`` (the share of
first-stage tokens that are not the reference's choice) and ``gap_max``
(the widest single gap) are printed beside them for the record.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import codec as ref


def token_numbers(codec: ref.Codec, sd, wav: torch.Tensor, tokens: torch.Tensor, ilen: int):
    """Codeword score gaps of served tokens (n_q, frames) along the reference's
    residual of the float waveform `wav` (T,); returns the numbers and the
    reference's encoder scale."""
    frames = -(-ilen // codec.hop)
    z, scale = ref.encode_latents(codec, sd, wav[None])
    embed = sd["quantizer.rq.model.embed"].float()
    r = z[0, :frames].float()
    gaps, q0_flip = [], 0.0
    for q in range(tokens.shape[0]):
        s = ref.scores(r, embed[q])
        chosen = tokens[q, :frames]
        best = s.max(dim=-1)
        gaps.append((best.values - s.gather(1, chosen[:, None])[:, 0]) / s.std(dim=-1))
        if q == 0:
            q0_flip = float((best.indices != chosen).float().mean())
        r = r - embed[q][chosen]
    gap = torch.stack(gaps)
    return {"token_gap": float(gap.mean()), "gap_max": float(gap.max()), "q0_flip": q0_flip}, scale


def judge_one(codec: ref.Codec, sd, sample: dict, n_q: int, device) -> Dict[str, float]:
    """sample: pcm (padded row, int16), ilen, tokens (n_q, frames of the
    row), recon (ilen,) int16."""
    wav = torch.from_numpy(sample["pcm"].astype(np.float32) / 32768.0).to(device)
    tokens = torch.from_numpy(np.asarray(sample["tokens"], np.int64)).to(device)
    ilen = int(sample["ilen"])
    with torch.no_grad():
        numbers, scale = token_numbers(codec, sd, wav, tokens[:n_q], ilen)
        recon = ref.decode(codec, sd, ref.rvq_decode(sd, tokens[:, None, :]), scale)
        want = ref.pcm16_float(recon, torch.tensor([ilen], device=device))[0, :ilen]
        got = torch.from_numpy(np.asarray(sample["recon"], np.float32)).to(device)[:ilen]
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp_min(1e-9))
    return dict(numbers, recon_err=err)


def judge(codec: ref.Codec, sd, samples: List[dict], n_q: int, device) -> Dict[str, float]:
    """The worst sampled request's numbers."""
    rows = [judge_one(codec, sd, s, n_q, device) for s in samples]
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def control_outputs(codec: ref.Codec, sd, sample: dict, n_q: int, device) -> dict:
    """The reference in fp8 put in the program's place: the sample with its
    tokens and PCM16 recomputed by the fp8 control."""
    wav = torch.from_numpy(sample["pcm"].astype(np.float32) / 32768.0).to(device)[None]
    ilen = int(sample["ilen"])
    with torch.no_grad():
        idx, pcm = ref.serve(codec, sd, wav, torch.tensor([ilen], device=device), n_q, ref.Fp8())
    return dict(sample, tokens=idx[:, 0].cpu().numpy(), recon=pcm[0, :ilen].cpu().numpy())
