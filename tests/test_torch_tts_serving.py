"""The port's continuous-batching session (models/tts_serving.py) on the CPU.

A session decode of a request equals the port's batch-1 decode_codec of it
with the same seed, under slot reuse, mixed caps, prompts and any bucket
size (sampling on); greedy session tokens equal the JAX session's; a
ServingPool over two CPU devices serves the same tokens.
"""

import numpy as np
import pytest
import torch

import jax

from funcodec_tpu.models.tts_serving import LauraServingSession as JaxSession
from funcodec_tpu_torch.models.tts_serving import LauraServingSession, ServingPool
from test_torch_laura import BINS, DIN, laura_pair, tiny_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return laura_pair(tiny_config("uni"), seed=3)  # eos reachable: rows stop before their caps too


def _requests(n, seed=0):
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        lt = int(rs.randint(3, 8))
        plen = int(rs.randint(1, 4)) if i % 2 else 0
        reqs.append(dict(uid=f"r{i}", text=rs.randn(lt, DIN).astype(np.float32),
                         prompt=rs.randint(0, BINS, (plen, 2)) if plen else None,
                         cap=int(rs.randint(3, 11)), seed=100 + i))
    return reqs


def _single(tm, r, sampling):
    out = tm.decode_codec(r["text"][None], np.array([len(r["text"])]), max_length=r["cap"], sampling=sampling,
                          seed=r["seed"], continual=r["prompt"])
    return out.reshape(-1, 2)


@pytest.mark.parametrize("bucket", [1, 32])
def test_session_equals_single_decode_with_sampling(pair, bucket):
    """7 requests over 3 slots (slot reuse), caps 3-10, prompts on half,
    incremental submits between polls, top-k sampling."""
    _, _, tm = pair
    reqs = _requests(7)
    sess = LauraServingSession(tm, num_slots=3, max_new=10, prefix_budget=16, sampling=5, segment_steps=4,
                               text_bucket=bucket, prompt_bucket=bucket)
    out = {}
    for r in reqs[:4]:
        sess.submit(r["uid"], r["text"], r["seed"], prompt=r["prompt"], max_new=r["cap"])
    out.update(sess.poll())
    for r in reqs[4:]:
        sess.submit(r["uid"], r["text"], r["seed"], prompt=r["prompt"], max_new=r["cap"])
    out.update(sess.drain())
    assert sorted(out) == sorted(r["uid"] for r in reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r["uid"]], _single(tm, r, 5), err_msg=r["uid"])
    assert sess.stats["host_syncs"] == sess.stats["segments"]
    assert sess.stats["emitted"] == sum(len(out[r["uid"]]) - (0 if r["prompt"] is None else len(r["prompt"]))
                                        for r in reqs)


def test_greedy_session_equals_jax_session():
    jm, params, tm = laura_pair(tiny_config("uni"), seed=4, eos_bias=-10.0)
    reqs = _requests(5, seed=1)
    kw = dict(num_slots=2, max_new=10, prefix_budget=16, sampling=False, segment_steps=4)
    jsess, tsess = JaxSession(jm, params, **kw), LauraServingSession(tm, **kw)
    for r in reqs:
        jsess.submit(r["uid"], r["text"], jax.random.PRNGKey(r["seed"]), prompt=r["prompt"], max_new=r["cap"])
        tsess.submit(r["uid"], r["text"], r["seed"], prompt=r["prompt"], max_new=r["cap"])
    ref, out = jsess.drain(), tsess.drain()
    assert sorted(out) == sorted(ref)
    for uid in ref:
        np.testing.assert_array_equal(out[uid], np.asarray(ref[uid]), err_msg=uid)
    assert tsess.stats["live_steps"] == jsess.stats["live_steps"]


def test_serving_pool_over_two_cpu_devices(pair):
    _, _, tm = pair
    reqs = _requests(5, seed=2)
    pool = ServingPool(tm, devices=["cpu", "cpu"], num_slots=2, max_new=10, prefix_budget=16, sampling=0.8,
                       segment_steps=3)
    assert pool.sessions[0].model is tm and pool.sessions[1].model is tm
    for r in reqs:
        pool.submit(r["uid"], r["text"], r["seed"], prompt=r["prompt"], max_new=r["cap"])
    out = pool.drain()
    for r in reqs:
        np.testing.assert_array_equal(out[r["uid"]], _single(tm, r, 0.8), err_msg=r["uid"])
    assert pool.stats["segments"] >= 2


def test_session_rejects_split_pe():
    _, _, tm = laura_pair(tiny_config("split"), seed=1)
    with pytest.raises(NotImplementedError, match="split"):
        LauraServingSession(tm, num_slots=2, max_new=4, prefix_budget=8)
