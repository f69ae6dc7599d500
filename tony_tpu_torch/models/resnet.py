"""ResNet-v1.5 image classifier (BASELINE config #3).

Counterpart of ``tony_tpu/models/resnet.py``: the same ``ResNetConfig``,
presets, parameter and state trees and the same arithmetic, in PyTorch:

- **Layout.** The JAX model is NHWC with HWIO weights. The port takes the
  same NHWC ``images`` and runs on ``images.permute(0, 3, 1, 2)``, an NCHW
  view with channels-last strides, with OIHW weights held in
  ``torch.channels_last``, so cuDNN picks its NHWC kernels.
  ``params_from_numpy`` carries JAX's HWIO leaves to that layout.
- **SAME padding.** JAX pads ``total = max((ceil(n/s) - 1)·s + k - n, 0)``
  with ``total // 2`` in front and the rest at the end: (2, 3) for the 7×7/2
  stem, (0, 1) for a 3×3/2 conv or the 3×3/2 max pool on an even input. A
  symmetric ``padding=`` gives the same shapes and other numbers, so every
  conv and the pool take their pads from that formula.
- **BatchNorm** is JAX's functional ``_bn``, not ``nn.BatchNorm2d``: batch
  statistics in f32 over (N, H, W) with the biased variance, the running
  statistics ``m·s + (1 - m)·batch`` computed outside the graph and returned
  detached, the normalised value rounded to the compute dtype before
  ``· scale + bias``. ``F.batch_norm`` without affine does the
  normalisation: its backward saves the input and two per-channel vectors,
  not the f32 temporaries of the formula written op by op.

The running statistics ride in the batch (``batch["bn_state"]``) and come
back in ``loss_fn``'s aux, as in JAX; the trainer carries no BN state.
``sharding_rules`` are JAX's; the forward refuses a mesh beyond the data
axis (no entry point of ResNet builds one: ROADMAP queue A8c, with the
sharded BN state).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from tony_tpu_torch.models import convert
from tony_tpu_torch.models.mlp import classification_loss
from tony_tpu_torch.parallel.mesh import AXIS_FSDP, axis_size, context_degree
from tony_tpu_torch.parallel.sharding import P, ShardingRules

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BOTTLENECK = {50: True, 101: True, 18: False, 34: False}
BN_EPS = 1e-5


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    image_size: int = 224
    bn_momentum: float = 0.9
    dtype: str = "bfloat16"
    # the 7×7/2 stem as a space-to-depth 4×4/1 conv on 12 channels: the
    # same maths (``_stem_conv_s2d``)
    stem_s2d: bool = False

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def blocks(self) -> tuple[int, ...]:
        return STAGE_BLOCKS[self.depth]

    @property
    def bottleneck(self) -> bool:
        return BOTTLENECK[self.depth]


RESNET50 = ResNetConfig()
RESNET_TINY = ResNetConfig(depth=18, num_classes=10, width=8, image_size=32, dtype="float32")
PRESETS = {"resnet50": RESNET50, "tiny": RESNET_TINY}


def _block_convs(cfg: ResNetConfig, cin: int, cmid: int, cout: int, stride: int) -> list[tuple]:
    """(k, cin, cout, stride) of a block's main-path convs."""
    if cfg.bottleneck:
        return [(1, cin, cmid, 1), (3, cmid, cmid, stride), (1, cmid, cout, 1)]
    return [(3, cin, cmid, stride), (3, cmid, cout, 1)]


def _blocks(cfg: ResNetConfig):
    """(name, cin, cmid, cout, stride) of every residual block, in order."""
    expansion = 4 if cfg.bottleneck else 1
    cin = cfg.width
    for stage, n_blocks in enumerate(cfg.blocks):
        cmid = cfg.width * (2 ** stage)
        cout = cmid * expansion
        for b in range(n_blocks):
            yield f"stage{stage}_block{b}", cin, cmid, cout, 2 if (b == 0 and stage > 0) else 1
            cin = cout


def init(gen: torch.Generator, cfg: ResNetConfig, device: torch.device | str) -> tuple[dict, dict]:
    """(params, state): convs truncated normal in [-2, 2] · (2 / fan_in)^0.5
    (OIHW, channels-last), BN scale 1 and bias 0, the head normal ·
    C^-0.5; running mean 0 and variance 1 in f32. Drawn on ``device`` from
    ``gen``; the bits differ from the JAX init."""
    dt = cfg.tdtype

    def conv(k, cin, cout):
        t = torch.empty(cout, cin, k, k, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * (2.0 / (k * k * cin)) ** 0.5).to(dt).contiguous(memory_format=torch.channels_last)

    def bn_params(c):
        return {"scale": torch.ones(c, dtype=dt, device=device), "bias": torch.zeros(c, dtype=dt, device=device)}

    def bn_state(c):
        return {"mean": torch.zeros(c, dtype=torch.float32, device=device),
                "var": torch.ones(c, dtype=torch.float32, device=device)}

    params: dict[str, Any] = {"stem": {"conv": conv(7, 3, cfg.width), "bn": bn_params(cfg.width)}}
    state: dict[str, Any] = {"stem": {"bn": bn_state(cfg.width)}}
    for name, cin, cmid, cout, stride in _blocks(cfg):
        blk_p: dict[str, Any] = {}
        blk_s: dict[str, Any] = {}
        for i, (k, ci, co, _) in enumerate(_block_convs(cfg, cin, cmid, cout, stride)):
            blk_p[f"conv{i}"] = conv(k, ci, co)
            blk_p[f"bn{i}"] = bn_params(co)
            blk_s[f"bn{i}"] = bn_state(co)
        if cin != cout or stride != 1:
            blk_p["proj"] = conv(1, cin, cout)
            blk_p["proj_bn"] = bn_params(cout)
            blk_s["proj_bn"] = bn_state(cout)
        params[name], state[name] = blk_p, blk_s
    w = torch.randn(cout, cfg.num_classes, generator=gen, device=device) * cout ** -0.5
    params["head"] = {"w": w.to(dt), "b": torch.zeros(cfg.num_classes, dtype=dt, device=device)}
    return params, state


def params_from_numpy(tree: dict, device) -> dict:
    """The JAX package's ResNet params (``jax.tree.map(np.asarray, params)``)
    as the port's tensors: HWIO conv leaves (every 4-D leaf) to OIHW in
    channels-last memory, the rest as they are."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node.dim() == 4:
            return node.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return node

    return walk(convert.params_from_numpy(tree, device))


def state_from_numpy(tree: dict, device) -> dict:
    """The JAX package's running statistics (f32 ``mean``/``var`` leaves)."""
    return convert.params_from_numpy(tree, device)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of a length-``n`` axis: (front, back)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """``lax.conv_general_dilated(..., "SAME")`` on NCHW ``x``, OIHW ``w``:
    the front pads through ``padding=``, the one extra back row and column
    an odd total leaves through ``F.pad``."""
    k = w.shape[-1]
    (hlo, hhi), (wlo, whi) = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if hhi > hlo or whi > wlo:
        x = F.pad(x, (0, whi - wlo, 0, hhi - hlo))
    return F.conv2d(x, w, stride=stride, padding=(hlo, wlo))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """The 3×3/2 ``reduce_window(max, -inf, SAME)``: ``padding=`` the front
    pad and ``ceil_mode`` for the back, which is the front pad or one more
    whenever the window is wider than the stride (a window running off the
    end sees -inf there, as in JAX)."""
    pads = tuple(same_pads(n, 3, 2)[0] for n in x.shape[2:])
    return F.max_pool2d(x, 3, 2, padding=pads, ceil_mode=True)


def _stem_conv_s2d(images: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7×7/2 stem as a space-to-depth 4×4/1 conv over 12 channels (JAX's
    ``_stem_conv_s2d``): the image padded (2, 4) (SAME's (2, 3) and one
    zero row and column that only meets the zero tap of the kernel padded
    to 8×8), cut into 2×2 blocks; the kernel's taps regrouped to match.

    images NHWC [B, S, S, 3] with even S; w OIHW [C, 3, 7, 7]. Returns NCHW."""
    B, S, _, Cin = images.shape
    C = w.shape[0]
    Sp = (S + 6) // 2
    x = F.pad(images, (0, 0, 2, 4, 2, 4))
    x = x.reshape(B, Sp, 2, Sp, 2, Cin).permute(0, 1, 3, 2, 4, 5).reshape(B, Sp, Sp, 4 * Cin)
    w8 = F.pad(w, (0, 1, 0, 1))                                         # [C, 3, 8, 8]
    ws = w8.reshape(C, Cin, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(C, 4 * Cin, 4, 4)
    return F.conv2d(x.permute(0, 3, 1, 2), ws.contiguous(memory_format=torch.channels_last))


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def _bn(x: torch.Tensor, p: dict, s: dict, momentum: float, train: bool) -> tuple[torch.Tensor, dict]:
    """JAX's ``_bn`` on NCHW ``x``: returns (out, new running statistics)."""
    if train:
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
                     "var": momentum * s["var"] + (1 - momentum) * var}
        out = F.batch_norm(x, None, None, training=True, eps=BN_EPS)
    else:
        new_s = s
        out = ((x.float() - _channel(s["mean"])) * _channel(torch.rsqrt(s["var"] + BN_EPS))).to(x.dtype)
    return out * _channel(p["scale"]) + _channel(p["bias"]), new_s


def sharding_rules(cfg: ResNetConfig) -> ShardingRules:
    """JAX's rules: the convolutions replicated, the head over fsdp and model."""
    return ShardingRules([(r"head/w", P("fsdp", "model")), (r".*", P())])


def _refuse_mesh(mesh) -> None:
    if context_degree(mesh) > 1 or axis_size(mesh, AXIS_FSDP) > 1:
        raise NotImplementedError(
            "ResNet runs on a data axis only: its forward over the fsdp and model axes of the "
            "JAX model's rules is not ported (ROADMAP queue A8c), and it has no context axis")


def forward(params: dict, state: dict, images: torch.Tensor, cfg: ResNetConfig,
            train: bool = True, mesh=None) -> tuple[torch.Tensor, dict]:
    """images NHWC [B, H, W, 3] → (logits [B, classes], new_state)."""
    _refuse_mesh(mesh)
    new_state: dict[str, Any] = {}
    images = images.to(cfg.tdtype)
    S = images.shape[1]
    if cfg.stem_s2d and S == images.shape[2] and S % 2 == 0:
        x = _stem_conv_s2d(images, params["stem"]["conv"])
    else:
        x = _conv(images.permute(0, 3, 1, 2), params["stem"]["conv"], 2)
    x, bn_s = _bn(x, params["stem"]["bn"], state["stem"]["bn"], cfg.bn_momentum, train)
    new_state["stem"] = {"bn": bn_s}
    x = _max_pool(torch.relu(x))

    for name, cin, cmid, cout, stride in _blocks(cfg):
        blk_p, blk_s = params[name], state[name]
        new_blk_s: dict[str, Any] = {}
        convs = _block_convs(cfg, cin, cmid, cout, stride)
        h = x
        for i, (_, _, _, s_i) in enumerate(convs):
            h = _conv(h, blk_p[f"conv{i}"], s_i)
            h, new_blk_s[f"bn{i}"] = _bn(h, blk_p[f"bn{i}"], blk_s[f"bn{i}"], cfg.bn_momentum, train)
            if i < len(convs) - 1:
                h = torch.relu(h)
        shortcut = x
        if "proj" in blk_p:
            shortcut = _conv(x, blk_p["proj"], stride)
            shortcut, new_blk_s["proj_bn"] = _bn(shortcut, blk_p["proj_bn"], blk_s["proj_bn"],
                                                 cfg.bn_momentum, train)
        x = torch.relu(h + shortcut)
        new_state[name] = new_blk_s

    x = x.mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"], new_state


def loss_fn(params: dict, batch: dict, cfg: ResNetConfig, mesh=None,
            state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Mean cross-entropy at the labels (f32 log-softmax). The running
    statistics are ``state``, else ``batch["bn_state"]``; the new ones are
    the aux's ``bn_state``."""
    logits, new_state = forward(params, state if state is not None else batch["bn_state"],
                                batch["image"], cfg, train=True, mesh=mesh)
    loss, acc = classification_loss(logits, batch["label"])
    return loss, {"loss": loss, "accuracy": acc, "bn_state": new_state}


def synthetic_batch(gen: torch.Generator, batch_size: int, cfg: ResNetConfig) -> dict:
    """``image`` NHWC [B, S, S, 3] f32 uniform in [0, 1), ``label`` uniform
    over the classes, drawn from ``gen`` on its device."""
    dev = gen.device
    S = cfg.image_size
    return {
        "image": torch.rand(batch_size, S, S, 3, generator=gen, device=dev),
        "label": torch.randint(0, cfg.num_classes, (batch_size,), generator=gen, device=dev),
    }


def config_from_dict(d: dict | str) -> ResNetConfig:
    if isinstance(d, str):
        return PRESETS[d]
    fields = {f.name for f in dataclasses.fields(ResNetConfig)}
    return dataclasses.replace(
        PRESETS.get(d.get("preset", ""), ResNetConfig()),
        **{k: v for k, v in d.items() if k in fields},
    )
