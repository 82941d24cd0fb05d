"""The LauraTTS program under test and its check against the plain
reference (``reference/laura.py``, the codec's decoder from
``reference/codec.py``).

The configuration file holds the recipe's yaml as run (``laura``), its
token list, the codec's FunCodec config (``funcodec``), the serving type,
the sampler and the kernel switches (``flags``).
``LauraProgram`` draws one set of seeded weights (the codec's, and the LM's
under an ``lm.`` prefix with the codec's codebooks copied into its frozen
``quantizer_codebook``), loads them into ``cli/text2audio_inference.
Text2Audio`` and serves through its incremental API (``start_serving``,
``submit``, ``poll``); the reference reads the same tensors.

The numbers that decide ``correct``, each the worst judged request's:

- ``logit_err``: the largest per-step relative L2 distance between the
  program's LM logits and the reference's full forward over the served
  groups. The program's logits come from replaying the judged requests'
  served groups teacher-forced through the program's own session (its
  slots, capacity and the stale rows of the window in place);
- ``recon_err``: relative L2 distance of the served ``gen`` PCM16 from the
  reference's synthesis of the served groups (wrap-padded to the decode
  length the program states, ``Text2Audio.synth_frames``, the same trim);
- ``graph_flip``: the share of groups that the session's CUDA graph (the
  step every decode of the window replays) draws otherwise than the eager
  step, both run from the state the window left (its rows in flight, the
  stale rows in place); limit 0. The teacher-forced replay above runs the
  eager step, so this ties what the window timed to what is judged;
- ``draw_flip`` (printed, not compared): the share of steps at which the
  reference, from its own logits and the request's uniforms, draws another
  group than the one served.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import codec as codec_side
from benchmark.harness import weights
from benchmark.harness.context import Run
from benchmark.reference import codec as ref
from benchmark.reference import laura as lref

CODEBOOK = "quantizer.rq.model.embed"


def pcm16(wav: np.ndarray) -> np.ndarray:
    """A served float waveform as the PCM16 the CLI writes (save_audio's
    peak rescale to 0.99, rounded)."""
    x = torch.from_numpy(np.asarray(wav, np.float32))[None]
    return torch.round(ref.pcm16_float(x, torch.tensor([x.shape[1]]))).clamp(-32768, 32767)[0].numpy().astype(
        np.int16)


class LauraProgram:
    """Text2Audio over the benchmark's weights, with the reference's view."""

    def __init__(self, run: Run):
        conf = run.cell.config
        self.conf = conf
        self.tokens = list(conf["token_list"])
        self.top_k = int(conf["top_k"])
        codec_side.set_flags(conf.get("flags", {}))
        from funcodec_tpu_torch.cli.text2audio_inference import Text2Audio

        self.model = lref.Laura.from_config(conf["laura"], len(self.tokens))
        self.codec = ref.Codec.from_config(conf["funcodec"])
        served = codec_side.DTYPES[conf["dtype"]]
        specs = self.codec.param_specs() + [(f"lm.{n}", s, law, b)
                                            for n, s, law, b in self.model.param_specs(CODEBOOK)]
        sd = weights.draw(specs, run.seed, run.device, {"encoder.": served, "decoder.": served, "lm.": served})
        # the eos entry of each group: random weights would end requests early
        # under top-k sampling; the traffic's caps set the lengths
        bias = sd["lm.codec_lm.decoder.bias"].view(self.model.predict_nq, self.model.bins + 1)
        bias[:, self.model.eos] = float(conf["eos_bias"])
        self.sd_lm, self.sd_codec = lref.state_dicts(sd)
        self.t2a = Text2Audio(conf["laura"], None, conf["funcodec"], None, token_list=self.tokens,
                              sampling=self.top_k, device=run.device, dtype=conf["dtype"])
        self.t2a.model.load_state_dict(self.sd_lm, strict=True)
        self.t2a.codec.model.load_state_dict(self.sd_codec, strict=True)
        self.hop = self.t2a.codec.hop_length
        self.sr = int(conf["funcodec"].get("sampling_rate", 16000))

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.t2a = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


GRAPH_STEPS = 50  # two segments of the cell


def graph_flip(prog: LauraProgram, steps: int = GRAPH_STEPS) -> float:
    """The share of the groups drawn in `steps` steps from the session's
    present state that its captured step (the CUDA graph) draws otherwise
    than its eager step from the same state; the state is restored between
    the two. 0.0 where the session has no graph (off a card)."""
    sess = prog.t2a.session
    graph = sess._graph
    if graph is None:
        return 0.0
    state = [sess.logits, sess.toks, sess.counts, sess.live, sess.cache.length, *sess.cache.k, *sess.cache.v]
    with torch.inference_mode():
        saved = [t.clone() for t in state]
        sess._segment(steps)
        by_graph = sess.toks.clone(), sess.counts.clone()
        for t, s in zip(state, saved):
            t.copy_(s)
        sess._graph = None
        try:
            sess._segment(steps)
        finally:
            sess._graph = graph
        emitted = int((sess.counts - saved[2]).sum())
        flips = int((by_graph[0] != sess.toks).any(-1).sum()) + int((by_graph[1] != sess.counts).sum())
    return flips / max(emitted, 1)


def replay_logits(prog: LauraProgram, samples: List[dict]) -> List[torch.Tensor]:
    """Each sample's LM logits (G, out_voc) fp32, its served groups
    teacher-forced through the program's session: the samples admitted into
    the first slots over what the window left there, every slot stepping
    (a sample's row writes while it has groups left, the others not)."""
    sess = prog.t2a.session
    dev = sess.device
    n = len(samples)
    sess._queue.clear()
    sess._staged = None
    sess._slot_uid = [None] * sess.B
    for i, s in enumerate(samples):
        sess.submit(f"judged{i}", s["ids"], s["seed"], max_new=len(s["tokens"]))
    sess._admit_ready()
    G = [len(s["tokens"]) for s in samples]
    forced = torch.zeros(sess.B, max(G), sess.cfg.predict_nq, dtype=torch.int64, device=dev)
    for i, s in enumerate(samples):
        forced[i, : G[i]] = torch.as_tensor(np.asarray(s["tokens"], np.int64), device=dev)
    lengths = torch.zeros(sess.B, dtype=torch.int64, device=dev)
    lengths[:n] = torch.as_tensor(G, device=dev)
    out = [sess.logits[:n].clone()]
    with torch.inference_mode():
        for t in range(max(G) - 1):
            logits, sess.cache = sess.model.lm_step(sess.cache, forced[:, t], None, sess.valid_key[:, None, :],
                                                    sess._rel_proj, sess.max_new, write_mask=lengths > t)
            out.append(logits[:n].float())
    steps = torch.stack(out, 1)
    return [steps[i, : G[i]] for i in range(n)]


def judge(prog: LauraProgram, samples: List[dict], device) -> Dict[str, float]:
    """The worst sample's numbers against the float32 reference. A sample
    holds its text ids, seed, served groups, the logits to judge and its
    PCM16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    with torch.no_grad():
        for s in samples:
            ids = torch.as_tensor(np.asarray(s["ids"], np.int64), device=device)
            groups = torch.as_tensor(np.asarray(s["tokens"], np.int64), device=device)
            want = lref.request_numbers(prog.model, prog.codec, prog.sd_lm, prog.sd_codec, ids, groups, s["seed"],
                                        prog.top_k, s["frames"])
            got_pcm = torch.as_tensor(np.asarray(s["pcm"], np.float32), device=device)
            if got_pcm.shape != want["pcm"].shape:  # a request served short of its frames
                recon = float("inf")
            else:
                recon = float(lref.relative_rows(got_pcm[None], want["pcm"][None])[0])
            rows.append({"logit_err": float(lref.relative_rows(s["logits"].to(device), want["logits"]).max()),
                         "recon_err": recon,
                         "draw_flip": float((want["draws"] != groups).any(-1).float().mean())})
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


def control(prog: LauraProgram, samples: List[dict], device) -> List[dict]:
    """The samples as the reference in fp8 serves their groups: its logits
    and its synthesis in the program's place."""
    out = []
    with torch.no_grad():
        for s in samples:
            ids = torch.as_tensor(np.asarray(s["ids"], np.int64), device=device)
            groups = torch.as_tensor(np.asarray(s["tokens"], np.int64), device=device)
            got = lref.request_numbers(prog.model, prog.codec, prog.sd_lm, prog.sd_codec, ids, groups, s["seed"],
                                       prog.top_k, s["frames"], ref.Fp8())
            out.append(dict(s, logits=got["logits"], pcm=torch.round(got["pcm"]).clamp(-32768, 32767).cpu().numpy()))
    return out


def span_ms(run: Run, name: str, per: str, device: bool = True) -> Optional[float]:
    """Milliseconds of the program's `name` spans inside the traced slice
    (device: between their CUDA events; else host), over the slice's count
    `per` (``run.work``); None where the program records no such span (a
    program without it, or no events: the CPU)."""
    try:
        from funcodec_tpu_torch.utils.profiling import device_ms, spans
    except ImportError:  # a program without spans
        return None
    t, n = run.tracer.result, run.work.get(per)
    if t is None or not n:
        return None
    within = (t.t0_ns, t.t1_ns)
    if device:
        ms = device_ms(name, within=within)
    else:
        got = spans(name, within=within)
        ms = 1e-6 * sum(s.host_ns for s in got) if got else None
    return None if ms is None else ms / n
