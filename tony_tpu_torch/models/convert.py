"""Weights into the port: the JAX package's trees and Hugging Face checkpoints.

``params_from_numpy(tree, device)`` takes the nested dict that
``jax.tree.map(np.asarray, params)`` gives (``QTensor(q, scale)`` leaves
included, as any ``(q, scale)`` named tuple) and returns the same tree of
torch tensors, layouts unchanged. bf16 arrays arrive with ``ml_dtypes``'
``bfloat16`` dtype, which ``torch.from_numpy`` refuses: they are viewed as
uint16 and reinterpreted as ``torch.bfloat16`` bit for bit, with neither
``ml_dtypes`` nor ``jax`` imported. ``blocks_from_numpy`` hands a gang's
rank its blocks of the same tree (``sharding.shard_params`` on its mesh:
the fsdp, expert and model axes), so a sharded run starts from JAX's weights; the
serving engine cuts a whole tree into its model-axis shards itself
(``generate.ModelShards``).

The rest is the counterpart of ``tony_tpu/models/convert.py``: an HF
``LlamaForCausalLM`` or ``MixtralForCausalLM`` state dict mapped onto the
port's tree (stacked layers, weights ``[in, out]``: HF's ``nn.Linear``
stores ``[out, in]``, so only transposes are needed; the rope convention,
GQA layout and untied head already line up). The config functions take an
HF config object or a plain mapping (a parsed ``config.json``), and the
tensors are written one layer at a time into their stacked leaves on the
named device, so no second copy of the checkpoint exists in f32 on the
host. A bf16 source into a bf16 leaf keeps its bits; an f32 source is
rounded to nearest even, as numpy/JAX round it.

``load_hf_dir(path, device, dtype)`` reads a checkpoint directory
(``config.json`` with ``model_type`` "llama" or "mixtral", and
``model.safetensors``, sharded ``model-*.safetensors`` with
``model.safetensors.index.json``, or ``pytorch_model.bin`` and its sharded
form) with the port's own safetensors reader: neither ``safetensors`` nor
``transformers`` is imported.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import struct
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.ops.quant import QTensor


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays / (q, scale) pairs → the same of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and set(tree._fields) == {"q", "scale"}:
        return QTensor(tensor_from_numpy(tree.q, device), tensor_from_numpy(tree.scale, device))
    return tensor_from_numpy(tree, device)


def blocks_from_numpy(tree, rules, mesh, device) -> dict:
    """This rank's blocks of a numpy tree on ``mesh`` per ``rules`` (the
    whole leaves where the mesh does not split them; Mixtral's rules cut
    the experts over expert, each expert's D over fsdp and its F over
    model)."""
    from tony_tpu_torch.parallel.sharding import shard_params

    return shard_params(params_from_numpy(tree, device), rules, mesh)


# -- Hugging Face configs ------------------------------------------------------------

def _get(hf_config, key: str, default=None):
    """``key`` of an HF config object or of a parsed ``config.json``."""
    if isinstance(hf_config, Mapping):
        return hf_config.get(key, default)
    return getattr(hf_config, key, default)


def _reject_unsupported(hf_config) -> None:
    """Checkpoint features the port's models do not implement raise here,
    rather than importing something that silently diverges."""
    scaling = _get(hf_config, "rope_scaling")
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type"))
        if kind not in ("llama3", "linear"):
            raise NotImplementedError(
                f"rope_scaling type {kind!r} is not implemented (llama3 and "
                "linear are; yarn/dynamic would silently diverge)")
    explicit_hd = _get(hf_config, "head_dim")
    derived_hd = _get(hf_config, "hidden_size") // _get(hf_config, "num_attention_heads")
    if explicit_hd is not None and explicit_hd != derived_hd:
        raise NotImplementedError(
            f"checkpoint head_dim {explicit_hd} != hidden_size/num_heads "
            f"{derived_hd}; the port's configs derive head_dim")
    if _get(hf_config, "attention_bias", False) or _get(hf_config, "mlp_bias", False):
        raise NotImplementedError(
            "attention_bias/mlp_bias checkpoints are not supported (the port's "
            "block has no bias terms)")


def _rope_scaling_tuple(hf_config) -> tuple:
    """HF rope_scaling dict → the hashable tuple ops/layers expects."""
    scaling = _get(hf_config, "rope_scaling")
    if not scaling:
        return ()
    kind = scaling.get("rope_type", scaling.get("type"))
    if kind == "linear":
        return ("linear", float(scaling["factor"]))
    if kind == "llama3":
        return ("llama3", float(scaling["factor"]), float(scaling["low_freq_factor"]),
                float(scaling["high_freq_factor"]), float(scaling["original_max_position_embeddings"]))
    raise NotImplementedError(f"rope_scaling type {kind!r}")


def config_from_hf(hf_config, dtype: str = "bfloat16", **overrides) -> LlamaConfig:
    """HF LlamaConfig (object or mapping) → the port's ``LlamaConfig``."""
    _reject_unsupported(hf_config)
    heads = _get(hf_config, "num_attention_heads")
    base = LlamaConfig(
        vocab_size=_get(hf_config, "vocab_size"),
        d_model=_get(hf_config, "hidden_size"),
        n_layers=_get(hf_config, "num_hidden_layers"),
        n_heads=heads,
        n_kv_heads=_get(hf_config, "num_key_value_heads", heads),
        d_ff=_get(hf_config, "intermediate_size"),
        max_seq=_get(hf_config, "max_position_embeddings"),
        rope_theta=_get(hf_config, "rope_theta", 10_000.0),
        norm_eps=_get(hf_config, "rms_norm_eps"),
        dtype=dtype,
        sliding_window=int(_get(hf_config, "sliding_window") or 0),
        rope_scaling=_rope_scaling_tuple(hf_config),
    )
    return dataclasses.replace(base, **overrides) if overrides else base


def config_from_hf_mixtral(hf_config, dtype: str = "bfloat16", **overrides):
    """HF MixtralConfig (object or mapping) → the port's ``MixtralConfig``.

    ``capacity_factor`` is num_experts/top_k, as JAX sets it: the lossless
    setting for the capacity dispatches (HF's routing drops nothing); the
    dispatch stays the default ragged one, which drops nothing either."""
    from tony_tpu_torch.models.mixtral import MixtralConfig

    _reject_unsupported(hf_config)
    base = MixtralConfig(
        vocab_size=_get(hf_config, "vocab_size"),
        d_model=_get(hf_config, "hidden_size"),
        n_layers=_get(hf_config, "num_hidden_layers"),
        n_heads=_get(hf_config, "num_attention_heads"),
        n_kv_heads=_get(hf_config, "num_key_value_heads"),
        d_ff=_get(hf_config, "intermediate_size"),
        max_seq=_get(hf_config, "max_position_embeddings"),
        rope_theta=_get(hf_config, "rope_theta", 1e6),
        norm_eps=_get(hf_config, "rms_norm_eps"),
        dtype=dtype,
        num_experts=_get(hf_config, "num_local_experts"),
        top_k=_get(hf_config, "num_experts_per_tok"),
        capacity_factor=_get(hf_config, "num_local_experts") / _get(hf_config, "num_experts_per_tok"),
    )
    return dataclasses.replace(base, **overrides) if overrides else base


# -- Hugging Face state dicts --------------------------------------------------------

# non-parameter buffers some transformers versions persist in state dicts
_IGNORABLE_SUFFIXES = ("rotary_emb.inv_freq",)


class _Consumer:
    """Tracks which state-dict keys the mapping consumed, writes each tensor
    into its leaf on ``device`` as it is consumed (one source tensor on the
    device at a time), and refuses to finish while any weight tensor is left
    unconsumed: silently dropping weights would give a model that runs but
    diverges."""

    def __init__(self, state_dict, cfg, device):
        self.sd = state_dict
        self.cfg = cfg
        self.device = torch.device(device)
        self.dt = cfg.tdtype
        self.consumed: set[str] = set()

    def take(self, key: str, transpose: bool) -> torch.Tensor:
        """The tensor on the device in its own dtype, ``[in, out]`` if asked."""
        self.consumed.add(key)
        w = self.sd[key].detach().to(self.device)
        return w.T if transpose else w

    def leaf(self, key: str, transpose: bool, dtype=None) -> torch.Tensor:
        w = self.take(key, transpose)
        return torch.empty(w.shape, dtype=dtype or self.dt, device=self.device).copy_(w)

    def stack(self, fmt: str, transpose: bool = True, dtype=None) -> torch.Tensor:
        """[L, ...]: layer i from ``fmt.format(i=i)``, filled one layer at a time."""
        out = None
        for i in range(self.cfg.n_layers):
            w = self.take(fmt.format(i=i), transpose)
            if out is None:
                out = torch.empty((self.cfg.n_layers, *w.shape), dtype=dtype or self.dt, device=self.device)
            out[i].copy_(w)
        return out

    def common(self) -> tuple[dict, dict]:
        """The embedding/attention/norm/lm-head mapping every Llama-family
        architecture shares. Returns (params, layer dict to extend)."""
        layers = {
            "attn_norm": self.stack("model.layers.{i}.input_layernorm.weight", transpose=False),
            "wq": self.stack("model.layers.{i}.self_attn.q_proj.weight"),
            "wk": self.stack("model.layers.{i}.self_attn.k_proj.weight"),
            "wv": self.stack("model.layers.{i}.self_attn.v_proj.weight"),
            "wo": self.stack("model.layers.{i}.self_attn.o_proj.weight"),
            "mlp_norm": self.stack("model.layers.{i}.post_attention_layernorm.weight", transpose=False),
        }
        params = {
            "embed": self.leaf("model.embed_tokens.weight", transpose=False),
            "layers": layers,
            "final_norm": self.leaf("model.norm.weight", transpose=False),
        }
        if "lm_head.weight" in self.sd:
            params["lm_head"] = self.leaf("lm_head.weight", transpose=True)
        else:  # tied embeddings
            params["lm_head"] = self.leaf("model.embed_tokens.weight", transpose=True)
        return params, layers

    def finish(self, params: dict) -> dict:
        leftover = [k for k in self.sd if k not in self.consumed and not k.endswith(_IGNORABLE_SUFFIXES)]
        if leftover:
            raise ValueError(
                f"state dict has {len(leftover)} unconsumed tensors (e.g. "
                f"{sorted(leftover)[:4]}): this checkpoint carries weights the "
                "port's model has no slot for — refusing a silently-wrong import")
        return params


def params_from_hf_state_dict(state_dict, cfg: LlamaConfig, device="cpu") -> dict:
    """HF LlamaForCausalLM state dict → the port's stacked-layer tree on
    ``device``. Missing ``lm_head.weight`` means a tied-embedding
    checkpoint: the embedding row matrix is reused."""
    c = _Consumer(state_dict, cfg, device)
    params, layers = c.common()
    layers.update(
        w_gate=c.stack("model.layers.{i}.mlp.gate_proj.weight"),
        w_up=c.stack("model.layers.{i}.mlp.up_proj.weight"),
        w_down=c.stack("model.layers.{i}.mlp.down_proj.weight"),
    )
    return c.finish(params)


def params_from_hf_mixtral_state_dict(state_dict, cfg, device="cpu") -> dict:
    """HF MixtralForCausalLM state dict → the port's Mixtral tree on ``device``.

    Expert naming: HF w1 = gate, w3 = up, w2 = down; the per-expert matrices
    stack into [L, E, ...] tensors, one expert at a time. The router imports
    in f32 (never rounded through the model dtype: bf16-rounded routing
    logits could flip near-tie expert selections against the HF forward)."""
    c = _Consumer(state_dict, cfg, device)
    params, layers = c.common()

    def stack_experts(which: str) -> torch.Tensor:
        out = None
        for i in range(cfg.n_layers):
            for e in range(cfg.num_experts):
                w = c.take(f"model.layers.{i}.block_sparse_moe.experts.{e}.{which}.weight", True)
                if out is None:
                    out = torch.empty((cfg.n_layers, cfg.num_experts, *w.shape), dtype=c.dt, device=c.device)
                out[i, e].copy_(w)
        return out

    layers.update(
        router=c.stack("model.layers.{i}.block_sparse_moe.gate.weight", dtype=torch.float32),
        we_gate=stack_experts("w1"),
        we_up=stack_experts("w3"),
        we_down=stack_experts("w2"),
    )
    return c.finish(params)


def _from_state_dict(kind: str, hf_config, state_dict, dtype: str, device, overrides: dict):
    if kind == "mixtral":
        cfg = config_from_hf_mixtral(hf_config, dtype=dtype, **overrides)
        return params_from_hf_mixtral_state_dict(state_dict, cfg, device), cfg
    cfg = config_from_hf(hf_config, dtype=dtype, **overrides)
    return params_from_hf_state_dict(state_dict, cfg, device), cfg


def from_hf(model, dtype: str = "bfloat16", device="cpu", **overrides):
    """One-call import: (params, cfg) from an HF LlamaForCausalLM or
    MixtralForCausalLM — any object with ``.state_dict()`` and ``.config``
    (dispatch on ``config.model_type``; transformers is never imported).
    For a bare state dict, build the config (``config_from_hf`` /
    ``config_from_hf_mixtral``) and call the matching
    ``params_from_hf*_state_dict``."""
    if hasattr(model, "state_dict") and hasattr(model, "config"):
        kind = getattr(model.config, "model_type", "llama")
        return _from_state_dict(kind, model.config, model.state_dict(), dtype, device, overrides)
    raise TypeError("pass an HF LlamaForCausalLM/MixtralForCausalLM; for a bare state dict use "
                    "the params_from_hf*_state_dict functions")


# -- checkpoint directories ----------------------------------------------------------

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


class _SafetensorsFile:
    """One ``.safetensors`` file, mapped: an 8-byte little-endian header
    length, a JSON header naming each tensor's ``dtype``, ``shape`` and
    ``data_offsets`` (from the end of the header), then the raw bytes. A
    tensor is a view of the mapping (copy-on-write, so the file is never
    written)."""

    def __init__(self, path: Path):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self.map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.base = 8 + n
        self.entries = header
        for name, e in header.items():
            if e["dtype"] not in _SAFETENSORS_DTYPES:
                raise ValueError(f"{path.name}: tensor {name!r} has dtype {e['dtype']}; the port reads "
                                 f"{sorted(_SAFETENSORS_DTYPES)}")

    def tensor(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dt = _SAFETENSORS_DTYPES[e["dtype"]]
        start, end = e["data_offsets"]
        count = (end - start) // dt.itemsize
        t = torch.frombuffer(self.map, dtype=dt, count=count, offset=self.base + start)
        return t.view(e["shape"])


class _LazyStateDict(Mapping):
    """name → tensor of a checkpoint's weight files, each read when asked for."""

    def __init__(self, readers: dict):
        self.readers = readers  # name → zero-argument function returning the tensor

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.readers[name]()

    def __iter__(self):
        return iter(self.readers)

    def __len__(self) -> int:
        return len(self.readers)


def _weight_files(path: Path) -> list[Path]:
    for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        if (path / index).is_file():
            weight_map = json.loads((path / index).read_text())["weight_map"]
            return [path / f for f in sorted(set(weight_map.values()))]
    for single in ("model.safetensors", "pytorch_model.bin"):
        if (path / single).is_file():
            return [path / single]
    raise FileNotFoundError(f"{path}: no model.safetensors, pytorch_model.bin or their sharded index")


def _read_state_dict(path) -> Mapping:
    """The state dict of an HF checkpoint directory, its tensors read lazily
    (safetensors by mmap, ``.bin`` files by ``torch.load(mmap=True)``), on
    the CPU in their stored dtypes."""
    readers = {}
    for f in _weight_files(Path(path)):
        if f.suffix == ".safetensors":
            st = _SafetensorsFile(f)
            readers.update({name: (lambda st=st, name=name: st.tensor(name)) for name in st.entries})
        else:
            sd = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
            readers.update({name: (lambda t=t: t) for name, t in sd.items()})
    return _LazyStateDict(readers)


def load_hf_dir(path, device="cpu", dtype: str | None = None):
    """(params, cfg) of an HF checkpoint directory on ``device``, dispatching
    on ``config.json``'s ``model_type`` ("llama" or "mixtral"; any other
    raises by name). ``dtype`` None takes the checkpoint's: float32 stays
    float32, any other is served as bfloat16."""
    path = Path(path)
    hf_config = json.loads((path / "config.json").read_text())
    kind = hf_config.get("model_type")
    if kind not in ("llama", "mixtral"):
        raise NotImplementedError(f"{path}: model_type {kind!r}; the port loads 'llama' and 'mixtral' "
                                  "checkpoints")
    if dtype is None:
        stored = hf_config.get("torch_dtype") or hf_config.get("dtype")
        dtype = "float32" if stored == "float32" else "bfloat16"
    return _from_state_dict(kind, hf_config, _read_state_dict(path), dtype, device, {})
