"""The JAX package's checkpoint files in the port, against funcodec_tpu, on the CPU.

Every file here is written by the JAX package itself (train/checkpoint.
save_weights / save_train_state, cli/average_nbest, its trainers and its
CLIs), at tiny widths, and read by the port:

- compat/flax_msgpack: ``restore`` of flax's bytes equals flax's own
  ``msgpack_restore`` (the same maps, dtypes, shapes and bytes), and
  ``to_bytes`` is byte-equal to ``flax.serialization.to_bytes``, over
  parametrised and hypothesis-drawn trees and a chunked array. Exact.
- compat/torch_import: each ``import_*`` equals the JAX ``import_*`` on one
  state_dict, leaf for leaf (exact), and the weights file it makes is
  byte-equal to JAX's ``save_weights`` of JAX's tree.
- Speech2Token from a JAX ``.ckpt`` gives the JAX CLI's tokens exactly in
  fp32 (EnCodec, FreqCodec, a residual_quantizer codec), the recon within
  1e-4 (summation order, as tests/test_torch_encodec.py holds it).
- Text2Audio from a Laura ``.ckpt`` holds JAX's weights exactly and
  decodes JAX's greedy tokens; graft_codebooks from a codec ``.ckpt``
  grafts JAX's codebooks exactly.
- cli/average_nbest on a JAX experiment directory writes a file
  byte-equal to the JAX CLI's.
- The GAN and Laura trainers continue a JAX run from its checkpoint.ckpt +
  reporter.json: the step, the epoch and the Adam moments exactly; the
  next step's stats within tests/test_torch_trainer_parity.py's rtol 2e-3
  (GAN) and tests/test_torch_laura_trainer.py's rtol 1e-4 (Laura).
- A malformed ``.ckpt`` raises a ValueError that names the file.
"""

import collections
import json
import shutil

import ml_dtypes
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization, struct
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import funcodec_tpu.cli.average_nbest as javg
import funcodec_tpu.cli.codec_inference as jcli
import funcodec_tpu.cli.text2audio_inference as jtts
import funcodec_tpu.cli.text2audio_train as jtrain_cli
import funcodec_tpu.compat.torch_import as jimport
import funcodec_tpu_torch.cli.average_nbest as tavg
import funcodec_tpu_torch.cli.codec_inference as tcli
import funcodec_tpu_torch.cli.text2audio_inference as ttts
import funcodec_tpu_torch.cli.text2audio_train as ttrain_cli
import funcodec_tpu_torch.compat.torch_import as timport
from funcodec_tpu.data.dataset import CodecDataset as JDataset
from funcodec_tpu.data.preprocessor import CodecPreprocessor as JPre
from funcodec_tpu.models.hifigan_gen import HiFiGANConfig as JHiFiGANConfig
from funcodec_tpu.models.hifigan_gen import HiFiGANGenerator as JHiFiGAN
from funcodec_tpu.quant.rvq import RVQState
from funcodec_tpu.tasks.codec import build_codec_model as jbuild
from funcodec_tpu.train import step as jstep
from funcodec_tpu.train.checkpoint import save_weights as jsave
from funcodec_tpu.train.gan_trainer import GANCodecTrainer as JTrainer
from funcodec_tpu.train.gan_trainer import TrainerOptions as JOptions
from funcodec_tpu_torch.compat import flax_msgpack as fm
from funcodec_tpu_torch.compat.from_jax import laura_state_dict_from_jax, state_dict_from_jax
from funcodec_tpu_torch.data.dataset import CodecDataset as TDataset
from funcodec_tpu_torch.data.preprocessor import CodecPreprocessor as TPre
from funcodec_tpu_torch.data.wav_io import write_wav
from funcodec_tpu_torch.models.hifigan_gen import HiFiGANConfig, HiFiGANGenerator
from funcodec_tpu_torch.tasks.codec import build_codec_model as tbuild
from funcodec_tpu_torch.train import checkpoint as tckpt
from funcodec_tpu_torch.train import laura_trainer as tlaura
from funcodec_tpu_torch.train.gan_trainer import GANCodecTrainer as TTrainer
from funcodec_tpu_torch.train.gan_trainer import TrainerOptions as TOptions
from test_torch_encodec import _config, _pair
from test_torch_freqcodec import tiny_config as freq_config
from test_torch_gan_step import LR, build_pair, np_tree
from test_torch_gan_step import config as gan_config
from test_torch_laura import BINS, DIM, DIN, NQ, laura_pair, tiny_config

torch.set_num_threads(1)

RECON_TOL = 1e-4  # fp32 recon, summation order (tests/test_torch_encodec.py)
GAN_STEP_RTOL = 2e-3  # tests/test_torch_trainer_parity.py's carried step
LAURA_STEP_RTOL = 1e-4  # tests/test_torch_laura_trainer.py's carried steps


# ---------------------------------------------------------------------------
# compat/flax_msgpack against flax.serialization
# ---------------------------------------------------------------------------

NT = collections.namedtuple("NT", "a b c")
Empty = collections.namedtuple("Empty", "")


@struct.dataclass
class Carry:
    x: object
    y: object
    meta: object = struct.field(pytree_node=False, default="left out")


DTYPES = [np.float16, np.float32, np.float64, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
          np.uint32, np.uint64, np.bool_, np.complex64, np.complex128, ml_dtypes.bfloat16,
          ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2]


def _array(rs, dtype, shape):
    """Arbitrary bit patterns of `dtype` (NaNs too: compared by bytes)."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    a = np.frombuffer(rs.bytes(n), np.uint8).copy()
    if dtype is np.bool_:
        a &= 1
    return a.view(dtype).reshape(shape)


def _cases():
    rs = np.random.RandomState(0)
    return {
        "every_dtype": {np.dtype(d).name: _array(rs, d, (2, 3)) for d in DTYPES},
        "zero_d_and_empty": {"s": np.array(3.5, np.float32), "e": np.zeros((0, 4), np.int64), "e0": np.zeros((0,)),
                             "bf": np.zeros((3, 0), ml_dtypes.bfloat16), "b0": np.array(1, ml_dtypes.bfloat16)},
        "numpy_scalars": {"f": np.float32(1.5), "d": np.float64(-2.0), "i": np.int8(-3), "u": np.uint64(2**64 - 1),
                          "b": np.bool_(True), "c": np.complex64(1 - 2j), "bf": ml_dtypes.bfloat16(0.5)},
        "python_scalars": {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
                                    -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
                           "floats": [0.0, -0.0, 1.5, 1e300, float("inf"), float("nan")], "none": None,
                           "bools": (True, False), "complex": 3 + 4j},
        "strings_and_bytes": {"": "", "short": "x" * 31, "str8": "y" * 32, "str16": "z" * 256, "str32": "w" * 65536,
                              "utf8": "ß€😀", "bin": b"", "bin8": b"\x00" * 255, "bin16": b"\x01" * 256,
                              "bin32": b"\x02" * 65536},
        "containers": {"list": [1, [2, [3, []]], ()], "tuple": (np.arange(3), {"k": None}),
                       "nt": NT(np.ones(2), [1, 2], Empty()), "big_map": {str(i): i for i in range(70000)},
                       "map16": {f"k{i}": np.int32(i) for i in range(20)}, 5: "int key"},
        "structs": {"rvq": RVQState(*(_array(rs, np.float32, (i + 1, 2)) for i in range(4))),
                    "carry": Carry(jnp.int32(7), {"z": jnp.ones(3, jnp.bfloat16)}),
                    "adam": optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3)).init(
                        {"w": jnp.ones((2, 2)), "b": [jnp.zeros(3)]})},
        "torch_leaves": {"f": torch.arange(6.0).reshape(2, 3), "bf": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
                         "i": torch.tensor(4), "h": torch.ones(2, dtype=torch.float16)[::1]},
        "ext_sizes": {f"n{n}": np.zeros(n, np.uint8) for n in (0, 1, 2, 3, 4, 8, 16, 200, 240, 300, 70000)},
    }


def _torch_to_jax(tree):
    """The same values with torch leaves as numpy (ml_dtypes) arrays, for flax's writer."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.float().numpy().astype(ml_dtypes.bfloat16)
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _torch_to_jax(v) for k, v in tree.items()}
    return tree


def _raw(x):
    """(dtype name, shape, bytes) of an array leaf; a numpy scalar as its 0-d array."""
    if isinstance(x, torch.Tensor):
        return fm._TORCH_NAMES.get(x.dtype, None) or str(x.numpy().dtype), tuple(x.shape), fm._array(x).data.tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.shape, a.tobytes()


def assert_same_tree(got, want, path="tree"):
    """`got` (the port's restore) equals `want` (flax's msgpack_restore):
    maps with the same keys in the same order, arrays and numpy scalars of
    the same dtype, shape and bytes, other leaves of the same type and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) or (isinstance(got, torch.Tensor) and got.dim() > 0):
        assert isinstance(got, (np.ndarray, torch.Tensor)), path
        assert _raw(got) == _raw(want), path
    elif isinstance(want, np.generic):
        if isinstance(got, torch.Tensor):  # a bf16 / float8 scalar
            assert got.dim() == 0 and _raw(got) == _raw(want), path
        else:
            assert type(got) is type(want) and _raw(got) == _raw(want), path
    elif isinstance(want, float):
        assert type(got) is float and np.float64(got).tobytes() == np.float64(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("case", sorted(_cases()))
def test_flax_msgpack_matches_flax(case):
    tree = _cases()[case]
    data = serialization.to_bytes(_torch_to_jax(tree))
    assert fm.to_bytes(tree) == data
    assert_same_tree(fm.restore(data), serialization.msgpack_restore(data))
    if case != "numpy_scalars":  # a bf16 numpy scalar comes back as a 0-d tensor, written back as a 0-d array
        assert fm.to_bytes(fm.restore(data)) == data


_leaf = st.one_of(
    st.none(), st.booleans(), st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=False),
    st.text(max_size=40), st.binary(max_size=300), st.complex_numbers(allow_nan=False),
    st.tuples(st.sampled_from(DTYPES), st.lists(st.integers(0, 3), max_size=3), st.integers(0, 2**31 - 1)).map(
        lambda t: _array(np.random.RandomState(t[2]), t[0], tuple(t[1]))),
    st.tuples(st.sampled_from(DTYPES), st.integers(0, 2**31 - 1)).map(
        lambda t: _array(np.random.RandomState(t[1]), t[0], ())[()]),
)
_trees = st.recursive(_leaf, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.lists(inner, max_size=4).map(tuple),
    st.dictionaries(st.text(max_size=8), inner, max_size=5),
    st.tuples(inner, inner, inner).map(lambda t: NT(*t)),
    st.tuples(inner, inner).map(lambda t: Carry(*t))), max_leaves=12)


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_trees)
def test_flax_msgpack_matches_flax_on_drawn_trees(tree):
    data = serialization.to_bytes(tree)
    assert fm.to_bytes(tree) == data
    assert_same_tree(fm.restore(data), serialization.msgpack_restore(data))


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes (patched down to 64 on both sides)
    are written as flax chunks them and joined again on restore."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(1)
    tree = {"w": _array(rs, np.float32, (5, 7)), "small": np.ones(3, np.float32), "nested": {
        "bf": _array(rs, ml_dtypes.bfloat16, (50,)), "i8": _array(rs, np.int8, (3, 30))}}
    data = serialization.to_bytes(tree)
    assert fm.to_bytes(tree) == data
    assert b"__msgpack_chunked_array__" in data
    got = fm.restore(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    assert isinstance(got["nested"]["bf"], torch.Tensor) and got["nested"]["bf"].dtype == torch.bfloat16
    bf = {**tree, "nested": {**tree["nested"], "bf": got["nested"]["bf"]}}  # the torch leaf written back
    assert fm.to_bytes(bf) == data


# ---------------------------------------------------------------------------
# compat/torch_import against funcodec_tpu/compat/torch_import
# ---------------------------------------------------------------------------


def assert_same_jax_tree(got, want, path="params"):
    """The port's tree (numpy) equals JAX's (jax arrays): the same containers
    (a JAX struct against the port's namedtuple by field), dtypes, values."""
    if isinstance(want, RVQState):
        for name in ("inited", "cluster_size", "embed", "embed_avg"):
            assert_same_jax_tree(getattr(got, name), getattr(want, name), f"{path}.{name}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same_jax_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_jax_tree(a, b, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


def _wn_config():
    cfg = _config(causal=True, codec_dim=8)
    for k in ("encoder_conf", "decoder_conf"):
        cfg[k] = dict(cfg[k], norm="weight_norm", true_skip=False)
    return cfg


CODEC_IMPORTS = {"encodec": lambda: _config(), "weight_norm_lstm_proj": _wn_config,
                 "freqcodec_grouped": lambda: freq_config(2, 8)}


@pytest.mark.parametrize("name", sorted(CODEC_IMPORTS))
def test_import_encodec_matches_jax_and_writes_jax_bytes(name, tmp_path):
    config = CODEC_IMPORTS[name]()
    jm, _ = jbuild(config)
    tm, _ = tbuild(config, device="cpu", generator=torch.Generator().manual_seed(3))
    sd = tm.state_dict()
    params, state = timport.import_encodec(sd, tm)
    j_params, j_state = jimport.import_encodec(sd, jm)
    assert_same_jax_tree(params, j_params)
    assert_same_jax_tree(state, j_state, "rvq_state")
    tckpt.save_jax_weights(str(tmp_path / "port.ckpt"), params, state)
    jsave(str(tmp_path / "jax.ckpt"), j_params, j_state)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    # the file back into a port model of the same config
    tm2, _ = tbuild(config, device="cpu", generator=torch.Generator().manual_seed(4))
    tckpt.load_jax_checkpoint_params(str(tmp_path / "port.ckpt"), tm2)
    for k, v in tm2.state_dict().items():
        if name == "weight_norm_lstm_proj" and k.endswith("weight_g"):
            continue  # the fused weights are compared below
        if name == "weight_norm_lstm_proj" and k.endswith("weight_v"):
            g = tm2.state_dict()[k[:-1] + "g"]
            want = timport.fuse_torch_weight_norm(sd[k[:-1] + "g"].numpy(), sd[k].numpy())
            got = timport.fuse_torch_weight_norm(g.numpy(), v.numpy())
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=k)  # fused twice: rounding
        else:
            assert torch.equal(v, sd[k]), k  # no weight norm: moved and transposed, bit for bit


def test_import_laura_and_lstm_match_jax(tmp_path):
    config = tiny_config("uni")
    jm, _, tm = laura_pair(config, seed=3)
    sd = tm.state_dict()
    params = timport.import_laura(sd, tm)
    j_params = jimport.import_laura(sd, jm)
    assert_same_jax_tree(params, j_params)
    tckpt.save_jax_weights(str(tmp_path / "port.ckpt"), params)
    jsave(str(tmp_path / "jax.ckpt"), j_params, None)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    _, _, tm2 = laura_pair(config, seed=5)
    tckpt.load_jax_params(str(tmp_path / "port.ckpt"), tm2)
    for k, v in tm2.state_dict().items():
        assert torch.equal(v, sd[k]), k
    lstm = {f"m.weight_{a}_l{l}": torch.randn(8, 2) for a in ("ih", "hh") for l in range(2)}
    lstm.update({f"m.bias_{a}_l{l}": torch.randn(8) for a in ("ih", "hh") for l in range(2)})
    assert_same_jax_tree(timport.import_lstm(lstm, "m", 2), jimport.import_lstm(lstm, "m", 2))
    w = np.random.RandomState(0).randn(4, 3, 5).astype(np.float32)
    g = np.random.RandomState(1).rand(4, 1, 1).astype(np.float32)
    np.testing.assert_array_equal(timport.fuse_torch_weight_norm(g, w), jimport.fuse_torch_weight_norm(g, w))


def test_import_hifigan_generator_matches_jax():
    kw = dict(in_channels=8, channels=16, upsample_scales=(2, 2), upsample_kernel_sizes=(4, 4),
              resblock_kernel_sizes=(3, 5), resblock_dilations=((1, 3), (1, 3)), global_channels=4)
    tm = HiFiGANGenerator(HiFiGANConfig(**kw), device="cpu", generator=torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    assert any(k.endswith("weight_v") for k in sd)
    assert_same_jax_tree(timport.import_hifigan_generator(sd, tm),
                         jimport.import_hifigan_generator(sd, JHiFiGAN(JHiFiGANConfig(**kw))))


# ---------------------------------------------------------------------------
# serving, grafting and averaging JAX-written files
# ---------------------------------------------------------------------------


def _speech(batch=2, length=3200, seed=0):
    return (0.25 * np.random.RandomState(seed).randn(batch, length)).astype(np.float32)


def _rq_config():
    cfg = _config()
    cfg["quantizer"] = "residual_quantizer"
    return cfg


SERVED = {"encodec": _config, "freqcodec": freq_config, "residual_quantizer": _rq_config}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_speech2token_serves_a_jax_ckpt(name, tmp_path, monkeypatch):
    """The JAX CLI's Speech2Token and the port's, from one file written by
    JAX's save_weights: fp32 tokens equal, the recon within 1e-4."""
    monkeypatch.setattr(jcli, "_CACHE_DIR", "disabled")
    config = SERVED[name]()
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    _, params, state, _ = _pair(config, seed=2)
    jsave(str(tmp_path / "model.ckpt"), params, state)
    cfg, ckpt = str(tmp_path / "config.yaml"), str(tmp_path / "model.ckpt")
    x = _speech()
    j_codes, _, j_recon, _ = jcli.Speech2Token(cfg, ckpt, bit_width=None)(x)
    t_codes, _, t_recon, _ = tcli.Speech2Token(cfg, ckpt, bit_width=None, device="cpu")(x)
    assert len(t_codes) == len(j_codes)
    for t, j in zip(t_codes, j_codes):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    np.testing.assert_allclose(t_recon, j_recon, atol=RECON_TOL, rtol=RECON_TOL)


@pytest.fixture(scope="module")
def laura_files(tmp_path_factory):
    """A tiny codec and a tiny Laura LM (the codec's codebooks grafted in),
    each written by JAX's save_weights, with their yamls."""
    root = tmp_path_factory.mktemp("laura_ckpt")
    codec_config = _config(n_q=NQ, bins=BINS, dim=DIM)
    (root / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    (root / "config.yaml").write_text(yaml.safe_dump(codec_config))  # beside codec.ckpt, as a codec run leaves it
    _, c_params, c_state, _ = _pair(codec_config, seed=1)
    jsave(str(root / "codec.ckpt"), c_params, c_state)
    config = tiny_config("uni")
    config.update(audio_max_duration=0.4, codec_token_rate=25)
    (root / "laura.yaml").write_text(yaml.safe_dump(config))
    jm, params, tm = laura_pair(config, seed=2, eos_bias=-10.0)
    params["quantizer_codebook"] = np.asarray(c_state.embed)[:NQ, :BINS, :DIM]
    jsave(str(root / "laura.ckpt"), params, None)
    return root


def test_text2audio_serves_a_jax_ckpt(laura_files, monkeypatch):
    """Text2Audio of both packages from the JAX-written LM and codec .ckpt
    files: the port holds JAX's weights exactly and decodes JAX's greedy
    tokens, with and without a prompt."""
    monkeypatch.setattr(jcli, "_CACHE_DIR", "disabled")
    files = [str(laura_files / n) for n in ("laura.yaml", "laura.ckpt", "codec.yaml", "codec.ckpt")]
    j = jtts.Text2Audio(*files)
    t = ttts.Text2Audio(*files, device="cpu")
    ref = laura_state_dict_from_jax(t.model, jax.tree_util.tree_map(np.asarray, j.params))
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    codec_ref = state_dict_from_jax(t.codec.model, jax.tree_util.tree_map(np.asarray, j.codec.params),
                                    jax.tree_util.tree_map(np.asarray, j.codec.rvq_state))
    for k, v in t.codec.model.state_dict().items():
        assert torch.equal(v, codec_ref[k]), k
    rs = np.random.RandomState(4)
    text = rs.randn(1, 6, DIN).astype(np.float32)
    prompt = rs.randint(0, BINS, (3, 2))
    for cont in (None, prompt):
        want = j.model.decode_codec(j.params, jnp.asarray(text), jnp.asarray([6]), max_length=10, sampling=False,
                                    key=jax.random.PRNGKey(0), continual=cont)
        got = t.model.decode_codec(text, np.array([6]), max_length=10, sampling=False, continual=cont)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("with_config", [True, False], ids=["codec_config", "config_beside"])
def test_graft_codebooks_from_a_jax_ckpt(laura_files, with_config):
    cfg = str(laura_files / "codec.yaml") if with_config else None
    _, params, tm = laura_pair(tiny_config("uni"), seed=6)
    want = jtrain_cli.graft_codebooks(params, str(laura_files / "codec.ckpt"), cfg)["quantizer_codebook"]
    ttrain_cli.graft_codebooks(tm, str(laura_files / "codec.ckpt"), cfg)
    np.testing.assert_array_equal(tm.quantizer_codebook.embed.numpy(), np.asarray(want))


def _jax_exp(root, config, epochs=3):
    """A JAX experiment directory: config.yaml, reporter.json (valid
    criterion best first: epochs 2, 3, 1) and {e}epoch.ckpt of seeded weights."""
    exp = root / "exp"
    exp.mkdir()
    (exp / "config.yaml").write_text(yaml.safe_dump(config))
    crit = [3.0, 1.0, 2.0][:epochs]
    stats = {str(e + 1): {"valid": {"generator_multi_spectral_recon_loss": c}, "train": {"loss": c}}
             for e, c in enumerate(crit)}
    (exp / "reporter.json").write_text(json.dumps({"stats": stats, "epoch": epochs}))
    for e in range(1, epochs + 1):
        _, params, state, _ = _pair(config, seed=10 + e)
        jsave(str(exp / f"{e}epoch.ckpt"), params, state)
    return exp


@pytest.mark.parametrize("nbest", [2, 3])
def test_average_nbest_on_a_jax_directory_is_byte_equal(tmp_path, nbest):
    exp = _jax_exp(tmp_path, _config())
    name = f"valid.generator_multi_spectral_recon_loss.ave_{nbest}best.ckpt"
    javg.main(["--exp_dir", str(exp), "--nbest", str(nbest), "--output", str(tmp_path / "jax.ckpt")])
    out = tavg.main(["--exp_dir", str(exp), "--nbest", str(nbest)])
    assert out == str(exp / name)
    assert (exp / name).read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    # mixed kinds among the chosen epochs are refused: epoch 2 (the best) as the port's .pth only
    tm, _ = tbuild(_config(), device="cpu")
    tckpt.load_jax_checkpoint_params(str(exp / "2epoch.ckpt"), tm)
    (exp / "2epoch.ckpt").unlink()
    tckpt.save_weights(str(exp / "2epoch.pth"), tm)
    with pytest.raises(SystemExit, match="both kinds"):
        tavg.main(["--exp_dir", str(exp), "--nbest", str(nbest)])


def _malformed(tmp_path, kind):
    path = tmp_path / "bad.ckpt"
    if kind == "empty":
        path.write_bytes(b"")
    elif kind == "truncated":
        path.write_bytes(fm.to_bytes({"params": {"w": np.ones(8, np.float32)}})[:-5])
    else:  # a msgpack file that is not a weights file
        path.write_bytes(fm.to_bytes({"foo": 1}))
    return path


@pytest.mark.parametrize("kind", ["empty", "truncated", "not_weights"])
def test_a_malformed_ckpt_raises_naming_the_file(tmp_path, kind):
    path = _malformed(tmp_path, kind)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(_config()))
    with pytest.raises(ValueError, match=str(path)):
        tcli.Speech2Token(str(tmp_path / "config.yaml"), str(path), device="cpu")
    _, _, tm = laura_pair(tiny_config("uni"), seed=7)
    with pytest.raises(ValueError, match=str(path)):
        tckpt.load_laura_weights(str(path), tm)
    with pytest.raises(ValueError, match=str(path)):
        ttrain_cli.graft_codebooks(tm, str(path))


# ---------------------------------------------------------------------------
# continuing a JAX run
# ---------------------------------------------------------------------------

MAX_LEN = 4096


def _gan_options(cls, out, max_epoch=1):
    return cls(output_dir=str(out), max_epoch=max_epoch, num_iters_per_epoch=2, batch_size=2, seed=0,
               log_interval=1000, keep_nbest_models=2, num_workers=1, optim_conf={"lr": LR, "betas": (0.5, 0.9)},
               optim2_conf={"lr": LR, "betas": (0.5, 0.9)}, num_valid_dump_wavs=0, use_tensorboard=False,
               shared_forward=True)


def _gan_config():
    """tests/test_torch_trainer_parity.py's cut model: no draws."""
    cfg = gan_config(num_quantizers=2)
    for k in ("encoder_conf", "decoder_conf"):
        cfg[k] = dict(cfg[k], ratios=[2], seq_layer_num=1)
    cfg["model_conf"] = dict(cfg["model_conf"], multi_spectral_window_powers_of_two=[6])
    return cfg


def _datasets(dataset_cls, pre_cls, scp):
    return (dataset_cls([(scp, "speech", "sound")], preprocess=pre_cls(train=True, speech_max_length=MAX_LEN)),
            dataset_cls([(scp, "speech", "sound")], preprocess=pre_cls(train=False, speech_max_length=MAX_LEN)))


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    """The JAX trainer's one epoch (2 steps) from seeded weights: its
    directory, its trainer (the jitted step is reused) and its final state."""
    root = tmp_path_factory.mktemp("gan_resume")
    rs = np.random.RandomState(0)
    lines = []
    for i, n in enumerate([2500, 3100, 3700, MAX_LEN]):
        w = 0.2 * np.sin(2 * np.pi * (120 + 50 * i) * np.arange(n) / 16000) + 0.05 * rs.randn(n)
        write_wav(root / f"u{i}.wav", w.astype(np.float32), 16000)
        lines.append(f"u{i} {root / f'u{i}.wav'}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    cfg = _gan_config()
    p = build_pair(cfg)
    jtr = JTrainer(p.jm, p.jdisc, _gan_options(JOptions, root / "jax"))
    j_state0 = jstep.create_gan_train_state(p.params, p.disc_params, p.state, jtr.optimizer_g, jtr.optimizer_d)
    j_state = jtr.run(j_state0, *_datasets(JDataset, JPre, str(root / "wav.scp")))
    return dict(root=root, cfg=cfg, jtr=jtr, j_state=j_state, saved=np_tree(j_state))


def _adam(opt_state):
    (adam,) = [s for s in opt_state if isinstance(s, dict) and "mu" in s]
    return adam


def test_gan_trainer_continues_a_jax_run(gan_run):
    """codec_train's trainer given the JAX run's directory: the step, the
    epoch, both modules, the Adam moments and counts and the gate carry of
    checkpoint.ckpt exactly; then the next step in both packages within
    rtol 2e-3."""
    root, saved = gan_run["root"], gan_run["saved"]
    exp = root / "port"
    shutil.copytree(root / "jax", exp, symlinks=True)
    jax_files = {p.name: p.read_bytes() for p in exp.iterdir() if p.is_file() and not p.is_symlink()}
    assert {"checkpoint.ckpt", "1epoch.ckpt", "reporter.json"} <= set(jax_files)
    tm, tdisc = tbuild(gan_run["cfg"], device="cpu", generator=torch.Generator().manual_seed(9))
    ttr = TTrainer(tm, tdisc, _gan_options(TOptions, exp, max_epoch=2))
    state, start = ttr.resume(ttr.init_state())
    assert start == 2 and state.step == int(saved.step) == 2
    sd = state_dict_from_jax(tm, saved.params, saved.rvq_state)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    jadam_g = [s for s in jax.tree_util.tree_leaves(saved.opt_state_g, is_leaf=lambda n: hasattr(n, "mu"))
               if hasattr(s, "mu")][0]
    adam = _adam(state.opt_state_g)
    assert adam["count"] == int(jadam_g.count) == 2 and state.opt_state_g[-1] == 2
    names = [n for n, _ in tm.named_parameters()]
    for key in ("mu", "nu"):
        ref = state_dict_from_jax(tm, getattr(jadam_g, key), saved.rvq_state)
        for n, t in zip(names, adam[key]):
            assert torch.equal(t, ref[n]), (key, n)
    assert float(state.gen_loss_carry) == float(saved.gen_loss_carry)

    x = (0.3 * np.random.RandomState(3).randn(2, MAX_LEN)).astype(np.float32)
    j_next, j_stats = gan_run["jtr"]._get_train_step()(jax.tree_util.tree_map(jnp.asarray, saved),
                                                      {"speech": jnp.asarray(x)}, jax.random.PRNGKey(0))
    t_state, t_stats = ttr._train_step(state, {"speech": torch.from_numpy(x)}, torch.Generator().manual_seed(0))
    for k, v in jax.device_get(j_stats).items():
        np.testing.assert_allclose(float(t_stats[k]), float(v), rtol=GAN_STEP_RTOL, atol=1e-5, err_msg=k)
    assert t_state.step == int(j_next.step) == 3


def test_gan_trainer_run_writes_beside_the_jax_files(gan_run):
    """The trainer's run from the JAX directory goes on to epoch 2 (step 4),
    keeps epoch 1's stats, and writes the port's files beside the JAX
    files, which stay as they were."""
    root = gan_run["root"]
    exp = root / "port_run"
    shutil.copytree(root / "jax", exp, symlinks=True)
    before = {p.name: p.read_bytes() for p in exp.iterdir() if p.is_file() and not p.is_symlink()}
    tm, tdisc = tbuild(gan_run["cfg"], device="cpu", generator=torch.Generator().manual_seed(9))
    ttr = TTrainer(tm, tdisc, _gan_options(TOptions, exp, max_epoch=2))
    state = ttr.run(ttr.init_state(), *_datasets(TDataset, TPre, str(root / "wav.scp")))
    assert state.step == 4
    rep = json.loads((exp / "reporter.json").read_text())
    assert rep["epoch"] == 2
    assert rep["stats"]["1"] == json.loads((root / "jax" / "reporter.json").read_text())["stats"]["1"]
    for name in ("checkpoint.pth", "2epoch.pth", "latest.pth"):
        assert (exp / name).exists(), name
    for name, data in before.items():
        if name != "reporter.json":
            assert (exp / name).read_bytes() == data, name  # the JAX files stay as they were
    assert (exp / "latest.ckpt").resolve() == (exp / "1epoch.ckpt").resolve()


def _laura_exp(tmp_path_factory):
    """The JAX Laura CLI's one epoch (tests/test_torch_laura_trainer.py's
    corpus and seeded LM, the codebook grafted from a JAX codec .ckpt)."""
    import test_torch_laura_trainer as lt

    root = tmp_path_factory.mktemp("laura_resume")
    rs = np.random.RandomState(0)
    lt._write_split(root, "train", 6, rs)
    lt._write_split(root, "valid", 2, rs)
    (root / "tokens.txt").write_text("".join(f"{t}\n" for t in lt.TOKENS))
    cfg = lt._config_dict()
    (root / "laura.yaml").write_text(yaml.safe_dump(cfg))
    codec_config = _config(n_q=NQ, bins=BINS, dim=DIM)
    (root / "codec.yaml").write_text(yaml.safe_dump(codec_config))
    _, c_params, c_state, _ = _pair(codec_config, seed=1)
    jsave(str(root / "codec.ckpt"), c_params, c_state)
    env = dict(root=root, params=laura_pair(cfg, token_list=lt.TOKENS, seed=4)[1])
    return env, lt


@pytest.fixture(scope="module")
def laura_run(tmp_path_factory):
    env, lt = _laura_exp(tmp_path_factory)
    args = lt._cli_args(env["root"], env["root"] / "jax_exp")
    args[args.index("--codec_init_param") + 1] = str(env["root"] / "codec.ckpt")
    mp = pytest.MonkeyPatch()
    seeded = jax.tree_util.tree_map(jnp.asarray, env["params"])
    mp.setattr(lt.jtrain.LauraTrainer, "init_state",
               lambda self, key: lt.jtrain.TrainState(step=jnp.int32(0), params=seeded,
                                                      opt_state=self.optimizer.init(seeded)))
    got = {}
    real_run = lt.jtrain.LauraTrainer.run

    def run(self, state, *a, **kw):
        got["trainer"] = self
        out = real_run(self, state, *a, **kw)
        got["state"] = lt.jtrain.TrainState(step=np.asarray(out.step), params=np_tree(out.params),
                                            opt_state=np_tree(out.opt_state))
        return out

    mp.setattr(lt.jtrain.LauraTrainer, "run", run)
    try:
        lt.jcli.main(args)
    finally:
        mp.undo()
    return dict(env, lt=lt, args=args, **got)


def test_laura_trainer_continues_a_jax_run(laura_run, monkeypatch):
    """text2audio_train's trainer given the JAX run's directory: the step,
    the epoch, the weights (the grafted codebook too) and Adam's moments
    and counts of checkpoint.ckpt exactly; the next two steps in both
    packages within rtol 1e-4; then the CLI continues to epoch 2 and
    writes the port's files beside JAX's."""
    lt, root, jstate = laura_run["lt"], laura_run["root"], laura_run["state"]
    exp = root / "port_exp"
    shutil.copytree(root / "jax_exp", exp, symlinks=True)
    _, _, tm = laura_pair(lt._config_dict(), token_list=lt.TOKENS, seed=8)
    options = tlaura.LauraTrainerOptions(output_dir=str(exp), optim_conf={"lr": lt.LR},
                                         scheduler_conf={"warmup_steps": lt.WARMUP})
    trainer = tlaura.LauraTrainer(tm, options)
    state, start = trainer.resume(trainer.init_state())
    assert start == 2 and state.step == int(jstate.step) == 3
    ref = laura_state_dict_from_jax(tm, jstate.params)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, ref[k]), k
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    adam, jadam = _adam(state.opt_state), jstate.opt_state[1][0]
    assert adam["count"] == int(jadam.count) == 3
    for key in ("mu", "nu"):
        sd = laura_state_dict_from_jax(tm, getattr(jadam, key))
        for n, t in zip(names, adam[key]):
            assert torch.equal(t, sd[n]), (key, n)

    jt = laura_run["trainer"]
    js = jax.tree_util.tree_map(jnp.asarray, jstate)
    for i in range(2):
        batch = lt._step_batch(40 + i)
        js, jstats = jt._step_fn()(js, jt._to_device(batch), jax.random.PRNGKey(0))
        state, stats = trainer.train_step(state, trainer.to_device(batch), torch.Generator())
        for k, v in stats.items():
            np.testing.assert_allclose(float(v), float(jstats[k]), rtol=LAURA_STEP_RTOL, atol=1e-7, err_msg=k)
    assert state.step == int(js.step) == 5

    run_dir = root / "port_cli"
    shutil.copytree(root / "jax_exp", run_dir, symlinks=True)
    before = {p.name: p.read_bytes() for p in run_dir.iterdir() if p.is_file() and not p.is_symlink()}
    env = dict(root=root, sd=laura_pair(lt._config_dict(), token_list=lt.TOKENS, seed=4)[2].state_dict())
    args = [a if a != str(root / "jax_exp") else str(run_dir) for a in laura_run["args"]]
    real = ttrain_cli.build_laura_model

    def build(*a, **kw):
        model = real(*a, **kw)
        model.load_state_dict(env["sd"])
        return model

    monkeypatch.setattr(ttrain_cli, "build_laura_model", build)
    _, final = ttrain_cli.main(args + ["--device", "cpu", "--max_epoch", "2"])
    assert final.step == 6
    rep = json.loads((run_dir / "reporter.json").read_text())
    assert rep["epoch"] == 2 and rep["stats"]["1"] == json.loads((root / "jax_exp" / "reporter.json").read_text())[
        "stats"]["1"]
    assert (run_dir / "2epoch.pth").exists() and (run_dir / "checkpoint.pth").exists()
    for name, data in before.items():
        if name != "reporter.json":
            assert (run_dir / name).read_bytes() == data, name
