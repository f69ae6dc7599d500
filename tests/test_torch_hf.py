"""Port parity for Hugging Face checkpoint loading (``tony_tpu_torch.models.convert``)
on the CPU, against the JAX package's ``tony_tpu.models.convert`` on the same
transformers models, built from small configs with seeded weights (nothing
is downloaded):

- configs field by field, and every leaf bit for bit after the same dtype,
  for Llama (untied, tied, llama3 and linear rope scaling, a sliding
  window) and Mixtral, from f32 and from bf16 weights;
- the same refusals (yarn scaling, a head_dim unlike hidden/heads,
  attention bias, an unconsumed tensor) from a config object and from its
  ``config.json`` mapping;
- the port's f32 logits on the loaded tree against transformers' own
  forward, under the JAX test's bound (2e-3 of the largest logit);
- ``load_hf_dir`` on directories written by ``save_pretrained`` (one
  safetensors file, shards with an index, ``pytorch_model.bin`` whole and
  sharded): the same tree as ``from_hf``; other model types and tensor
  dtypes refused by name;
- ``serving_http --hf <dir>``: the engine's greedy tokens equal to the JAX
  ``ContinuousBatcher`` on ``from_hf(model, dtype="float32")`` for a Llama
  directory, and a Mixtral directory served through the MoE engine;
  ``--tokenizer`` still refused.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# transformers also imports TensorFlow where it is installed, which these
# tests never use and which takes seconds: leave it out of this import
_use_tf = os.environ.get("USE_TF")
os.environ["USE_TF"] = "0"
try:
    transformers = pytest.importorskip("transformers")
finally:
    if _use_tf is None:
        del os.environ["USE_TF"]
    else:
        os.environ["USE_TF"] = _use_tf

from tony_tpu.models import convert as JC  # noqa: E402
from tony_tpu.models import serving as JS  # noqa: E402
from tony_tpu_torch.models import convert as TC  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.models import mixtral as TM  # noqa: E402
from tony_tpu_torch.models import serving as TS  # noqa: E402
from tony_tpu_torch.models import serving_http  # noqa: E402

_COMMON = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
               rms_norm_eps=1e-5, attn_implementation="eager")
LLAMA_CASES = {
    "untied": {},
    "tied": dict(tie_word_embeddings=True),
    "llama3": dict(rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
    "linear": dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
    "window": dict(sliding_window=16),  # HF's Llama ignores it: configs and leaves only
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as each gang rank has: tier-1 runs this file
    beside other workers, and a tiny model's step on a full thread pool
    only waits for CPUs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _llama(seed=0, **kw):
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**{**_COMMON, "rope_theta": 10_000.0, **kw})).eval()


def _mixtral(seed=0, **kw):
    torch.manual_seed(seed)
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        **{**_COMMON, "rope_theta": 1e6, "num_local_experts": 4, "num_experts_per_tok": 2, **kw})).eval()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _bits(a) -> np.ndarray:
    """The raw bits of a JAX array or a torch tensor (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_tree(got: dict, want: dict) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = _bits(got[name])
        w = _bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_same_config(port, jax_cfg) -> None:
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)


@pytest.mark.parametrize("case", sorted(LLAMA_CASES))
def test_llama_config_and_leaves_equal_jaxs(case):
    model = _llama(**LLAMA_CASES[case])
    for dtype in ("float32", "bfloat16"):
        jp, jcfg = JC.from_hf(model, dtype=dtype)
        tp, tcfg = TC.from_hf(model, dtype=dtype)
        assert isinstance(tcfg, TL.LlamaConfig)
        _assert_same_config(tcfg, jcfg)
        assert TC.config_from_hf(model.config.to_dict(), dtype=dtype) == tcfg
        _assert_same_tree(tp, jp)


def test_mixtral_config_and_leaves_equal_jaxs():
    model = _mixtral()
    for dtype in ("float32", "bfloat16"):
        jp, jcfg = JC.from_hf(model, dtype=dtype)
        tp, tcfg = TC.from_hf(model, dtype=dtype)
        assert isinstance(tcfg, TM.MixtralConfig)
        _assert_same_config(tcfg, jcfg)
        assert tcfg.capacity_factor == tcfg.num_experts / tcfg.top_k  # lossless, as JAX's
        assert TC.config_from_hf_mixtral(model.config.to_dict(), dtype=dtype) == tcfg
        assert tp["layers"]["router"].dtype == torch.float32
        _assert_same_tree(tp, jp)


@pytest.mark.parametrize("build", [_llama, _mixtral], ids=["llama", "mixtral"])
def test_bf16_checkpoint_keeps_its_bits(build):
    """A bf16 source into bf16 leaves: the checkpoint's bits, transposed (the
    router widened to f32 exactly)."""
    model = build().to(torch.bfloat16)
    jp, _ = JC.from_hf(model, dtype="bfloat16")
    tp, _ = TC.from_hf(model, dtype="bfloat16")
    _assert_same_tree(tp, jp)
    sd = model.state_dict()
    assert torch.equal(tp["layers"]["wo"][1], sd["model.layers.1.self_attn.o_proj.weight"].T)
    assert torch.equal(tp["embed"], sd["model.embed_tokens.weight"])


def _refusals():
    yarn = {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16}
    return {"yarn": dict(rope_scaling=yarn), "head_dim": dict(head_dim=32), "attention_bias": dict(attention_bias=True)}


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_the_same_refusals_as_jax(case):
    hf_cfg = transformers.LlamaConfig(**{**_COMMON, **_refusals()[case]})
    with pytest.raises(NotImplementedError):
        JC.config_from_hf(hf_cfg)
    for source in (hf_cfg, hf_cfg.to_dict()):
        with pytest.raises(NotImplementedError):
            TC.config_from_hf(source)
    with pytest.raises(NotImplementedError):
        TC.config_from_hf_mixtral(transformers.MixtralConfig(**{**_COMMON, **_refusals()[case]}))


def test_an_unconsumed_tensor_is_refused_as_jax_refuses_it():
    model = _llama()
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="unconsumed"):
        JC.params_from_hf_state_dict(sd, JC.config_from_hf(model.config, dtype="float32"))
    with pytest.raises(ValueError, match="unconsumed"):
        TC.params_from_hf_state_dict(sd, TC.config_from_hf(model.config, dtype="float32"))
    sd.pop("model.layers.0.self_attn.q_proj.bias")
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)  # a buffer, ignored by both
    TC.params_from_hf_state_dict(sd, TC.config_from_hf(model.config, dtype="float32"))


@pytest.mark.parametrize("build, case", [
    (_llama, "untied"), (_llama, "tied"), (_llama, "llama3"), (_llama, "linear"), (_mixtral, "mixtral"),
], ids=["untied", "tied", "llama3", "linear", "mixtral"])
def test_f32_logits_match_transformers(build, case):
    """The loaded tree through the port's f32 forward against transformers'
    forward, within 2e-3 of the largest logit (tests/test_convert.py's bound)."""
    model = build(**LLAMA_CASES.get(case, {}))
    params, cfg = TC.from_hf(model, dtype="float32")
    tokens = np.random.default_rng(1).integers(0, 256, (2, 32))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
        if isinstance(cfg, TM.MixtralConfig):
            got = TM.forward(params, torch.tensor(tokens), cfg)[0].numpy()
        else:
            got = TL.forward(params, torch.tensor(tokens), cfg).numpy()
    scale = np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() / scale < 2e-3, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """save_pretrained directories: {name: (model, dir)}."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for name, model, kw in (
        ("safetensors", _llama(), {}),
        ("sharded", _llama(), dict(max_shard_size="100KB")),
        ("bin", _llama(), dict(safe_serialization=False)),
        ("bin_sharded", _llama(), dict(safe_serialization=False, max_shard_size="100KB")),
        ("tied", _llama(tie_word_embeddings=True), {}),
        ("mixtral", _mixtral(), {}),
    ):
        model.save_pretrained(root / name, **kw)
        out[name] = (model, root / name)
    return out


def test_load_hf_dir_reads_every_layout_as_from_hf(hf_dirs):
    files = {name: sorted(p.name for p in d.iterdir()) for name, (_, d) in hf_dirs.items()}
    assert "model.safetensors" in files["safetensors"] and "pytorch_model.bin" in files["bin"]
    assert "model.safetensors.index.json" in files["sharded"]
    assert sum(f.endswith(".safetensors") for f in files["sharded"]) > 1
    assert "pytorch_model.bin.index.json" in files["bin_sharded"]
    assert sum(f.endswith(".bin") for f in files["bin_sharded"]) > 1
    want, want_cfg = TC.from_hf(hf_dirs["safetensors"][0], dtype="float32")
    for name in ("safetensors", "sharded", "bin", "bin_sharded"):
        got, cfg = TC.load_hf_dir(hf_dirs[name][1], "cpu")  # an f32 checkpoint stays f32
        assert cfg == want_cfg, name
        _assert_same_tree(got, want)
    for name in ("tied", "mixtral"):
        model, d = hf_dirs[name]
        want, want_cfg = TC.from_hf(model, dtype="bfloat16")
        got, cfg = TC.load_hf_dir(d, "cpu", "bfloat16")
        assert cfg == want_cfg
        _assert_same_tree(got, want)


def test_load_hf_dir_refuses_other_types_and_dtypes(hf_dirs, tmp_path):
    from safetensors.torch import save_file

    d = tmp_path / "mistral"
    d.mkdir()
    config = json.loads((hf_dirs["safetensors"][1] / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**config, "model_type": "mistral"}))
    with pytest.raises(NotImplementedError, match="'mistral'"):
        TC.load_hf_dir(d)
    d = tmp_path / "int"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(config))
    save_file({"model.norm.weight": torch.ones(64), "step": torch.zeros(1, dtype=torch.int64)},
              str(d / "model.safetensors"))
    with pytest.raises(ValueError, match="'step' has dtype I64"):
        TC.load_hf_dir(d)


SERVE = ["--device", "cpu", "--slots", "2", "--max-len", "64", "--page-len", "32", "--decode-chunk", "4"]
PROMPTS = [[3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13], [200, 201, 202, 203, 204]]


def _served(engine, reference) -> dict:
    """Both engines' greedy tokens for PROMPTS, checked equal."""
    for eng in (engine, reference):
        for i, p in enumerate(PROMPTS):
            eng.submit(p, 6 + i)
    got, want = engine.run(), reference.run()
    assert got == want
    assert [len(got[i]) for i in sorted(got)] == [6, 7, 8]
    return got


def test_hf_flag_serves_the_jax_engines_greedy_tokens(hf_dirs):
    model, d = hf_dirs["safetensors"]
    engine = serving_http.build_engine(serving_http.parse_args(["--hf", str(d), *SERVE]))
    assert engine.cfg.dtype == "float32" and engine.kv == "paged"
    jp, jcfg = JC.from_hf(model, dtype="float32")
    _served(engine, JS.ContinuousBatcher(jp, jcfg, num_slots=2, max_len=64, kv="paged", page_len=32,
                                         decode_chunk=4))


def test_hf_flag_serves_a_mixtral_directory_through_the_moe_engine(hf_dirs):
    """A Mixtral directory runs the engine's MoE branch on ``from_hf``'s
    tree: its tokens equal an engine built on that tree (the tree is held
    to JAX's leaf for leaf above, and the MoE engine to JAX's engine in
    ``tests/test_torch_mixtral.py``)."""
    model, d = hf_dirs["mixtral"]
    engine = serving_http.build_engine(serving_http.parse_args(["--hf", str(d), *SERVE]))
    assert isinstance(engine.cfg, TM.MixtralConfig) and engine.cfg.dtype == "float32"
    params, cfg = TC.from_hf(model, dtype="float32")
    _served(engine, TS.ContinuousBatcher(params, cfg, num_slots=2, max_len=64, kv="paged", page_len=32,
                                         decode_chunk=4))


def test_tokenizer_is_still_refused(hf_dirs):
    with pytest.raises(SystemExit):
        serving_http.parse_args(["--hf", str(hf_dirs["safetensors"][1]), "--tokenizer", "tok"])
