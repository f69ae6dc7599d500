"""The port's sharding rules and mesh fill against the JAX package's, in
one process on the CPU (the gangs that run them are in
``test_torch_fsdp.py``):

- ``spec_for`` of every leaf path of the five families' parameter trees
  (Llama, Mixtral, BERT, the MLP and ResNet, tiny configs) equals JAX's
  ``sharding_rules(cfg).spec_for`` on the same paths, a JAX
  ``PartitionSpec`` read as the tuple it is;
- ``fsdp_spec_tree``, ``batch_spec`` and ``path_str`` equal JAX's;
- ``MeshSpec.auto`` fills the devices into fsdp, as JAX's default fill, and
  refuses what JAX refuses; ``build`` refuses a slice count
  (``TPU_NUM_SLICES``) that no data, fsdp or stage axis absorbs;
- without a mesh, or with its fsdp axis at 1, ``shard``, ``gather`` and
  ``gathering`` move nothing and return the tensors they were given;
- the port's embedding take equals JAX's one-hot product, which JAX takes
  on a mesh with two axes above 1;
- the MLP and ResNet forwards refuse an fsdp mesh (A8c).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tony_tpu.models import bert as JB  # noqa: E402
from tony_tpu.models import llama as JL  # noqa: E402
from tony_tpu.models import mixtral as JMx  # noqa: E402
from tony_tpu.models import mlp as JMlp  # noqa: E402
from tony_tpu.models import resnet as JR  # noqa: E402
from tony_tpu.parallel import mesh as JMesh  # noqa: E402
from tony_tpu.parallel import sharding as JS  # noqa: E402
from tony_tpu_torch.models import bert as TB  # noqa: E402
from tony_tpu_torch.models import llama as TL  # noqa: E402
from tony_tpu_torch.models import mixtral as TMx  # noqa: E402
from tony_tpu_torch.models import mlp as TMlp  # noqa: E402
from tony_tpu_torch.models import resnet as TR  # noqa: E402
from tony_tpu_torch.parallel import mesh as TMesh  # noqa: E402
from tony_tpu_torch.parallel import sharding as TS  # noqa: E402


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _port_trees():
    """(family, port module, JAX module, port config, JAX config, port params)."""
    gen = torch.Generator().manual_seed(0)
    return [
        ("llama", TL, JL, TL.LLAMA_TINY, JL.LLAMA_TINY, TL.init(gen, TL.LLAMA_TINY, "cpu")),
        ("mixtral", TMx, JMx, TMx.MIXTRAL_TINY, JMx.MIXTRAL_TINY, TMx.init(gen, TMx.MIXTRAL_TINY, "cpu")),
        ("bert", TB, JB, TB.BERT_TINY, JB.BERT_TINY, TB.init(gen, TB.BERT_TINY, "cpu")),
        ("mlp", TMlp, JMlp, TMlp.MLPConfig(), JMlp.MLPConfig(), TMlp.init(gen, TMlp.MLPConfig(), "cpu")),
        ("resnet", TR, JR, TR.RESNET_TINY, JR.RESNET_TINY, TR.init(gen, TR.RESNET_TINY, "cpu")[0]),
    ]


@pytest.mark.parametrize("family", ["llama", "mixtral", "bert", "mlp", "resnet"])
def test_spec_for_every_leaf_path_is_jaxs(family):
    """Each of the family's leaf paths gets JAX's spec, and the rules split
    at least one leaf over fsdp (ResNet: its head)."""
    _, tmod, jmod, tcfg, jcfg, params = next(t for t in _port_trees() if t[0] == family)
    trules, jrules = tmod.sharding_rules(tcfg), jmod.sharding_rules(jcfg)
    names = [name for name, _ in _leaves(params)]
    assert names
    for name in names:
        assert trules.spec_for(name) == tuple(jrules.spec_for(name)), name
    specs = dict(_leaves(trules.spec_tree(params)))
    assert specs == {n: trules.spec_for(n) for n in names}
    assert any("fsdp" in spec for spec in specs.values())


def test_fsdp_spec_tree_batch_spec_and_path_str_are_jaxs():
    params = TL.init(torch.Generator().manual_seed(0), TL.LLAMA_TINY, "cpu")
    jtree = {k: jax.tree.map(lambda t: jnp.zeros(tuple(t.shape)), v) if isinstance(v, dict)
             else jnp.zeros(tuple(v.shape)) for k, v in params.items()}
    for min_size in (2 ** 12, 64, 10 ** 9):
        got = dict(_leaves(TS.fsdp_spec_tree(params, min_size=min_size)))
        want = dict(_leaves(jax.tree.map(tuple, JS.fsdp_spec_tree(jtree, min_size=min_size),
                                         is_leaf=lambda x: isinstance(x, JS.P))))
        assert got == want, min_size
    assert dict(_leaves(TS.fsdp_spec_tree(params)))["layers/wq"] == (None, "fsdp", None)  # a tie: the first
    assert TS.batch_spec() == tuple(JS.batch_spec()) == (("data", "fsdp"),)
    assert TS.batch_spec(("data",)) == tuple(JS.batch_spec(("data",)))
    path = jax.tree_util.tree_flatten_with_path({"layers": {"wq": 0}})[0][0][0]
    assert TS.path_str(("layers", "wq")) == JS.path_str(path) == "layers/wq"


@pytest.mark.parametrize("n, kw", [
    (1, {}), (2, {}), (4, {}), (8, {"model": 2}), (8, {"context": 2, "expert": 2}), (6, {"stage": 3}),
])
def test_mesh_spec_auto_fills_fsdp_as_jax(n, kw):
    assert TMesh.MeshSpec.auto(n, **kw).axis_sizes == JMesh.MeshSpec.auto(n, **kw).axis_sizes, (n, kw)
    assert TMesh.MeshSpec.auto(n, **kw).fsdp == n // int(np.prod(list(kw.values()) or [1]))
    with pytest.raises(ValueError, match="not divisible"):
        TMesh.MeshSpec.auto(n, model=n + 1)
    with pytest.raises(ValueError, match="not divisible"):
        JMesh.MeshSpec.auto(n, model=n + 1)


def test_one_process_fills_a_mesh_of_one_and_refuses_a_bigger_gang(monkeypatch):
    spec = TMesh.MeshSpec.auto()
    assert spec.fsdp == 1 and spec.data == 1
    mesh = spec.build("cpu")
    assert mesh.device_mesh is None and mesh.group is None and TMesh.context_degree(mesh) == 1
    with pytest.raises(ValueError, match="needs a gang of as many processes"):
        TMesh.MeshSpec(fsdp=2).build("cpu")
    with pytest.raises(ValueError, match="needs a gang of as many processes"):  # one shard a process
        TMesh.MeshSpec(fsdp=2, context=2).build("cpu")
    monkeypatch.setenv("TPU_NUM_SLICES", "2")
    with pytest.raises(ValueError, match="cannot place 2 slices"):
        TMesh.MeshSpec(context=2).build("cpu")


def test_an_fsdp_axis_of_one_moves_nothing():
    """No mesh, or a mesh whose fsdp axis is 1: every leaf whole, the
    placements on the gang's (stage, data, fsdp, expert, context, model) dims all ``Replicate``,
    and ``gather``/``gathering`` the identity."""
    from torch.distributed.tensor import Replicate

    rules = TL.sharding_rules(TL.LLAMA_TINY)
    w = torch.randn(4, 8)
    for mesh in (None, TMesh.MeshSpec().build("cpu")):
        assert TS.placements(rules.spec_for("embed"), mesh) == [Replicate()] * len(TMesh.GANG_AXES) == [Replicate()] * 6
        assert TS.shard(w, rules.spec_for("embed"), mesh) is w
        assert TS.gather(w, rules.spec_for("embed"), mesh) is w
        block = lambda x, lp: x  # noqa: E731
        assert TS.gathering(block, rules, mesh) is block
        layout = TS.Layout(rules, mesh)
        assert not layout.sharded and layout.dim("layers/wq") is None
        assert layout.full_shape("layers/wq", w) == (4, 8)


def test_mlp_and_resnet_forwards_refuse_an_fsdp_mesh():
    """No entry point of the MLP or ResNet builds a mesh: a mesh beyond the
    data axis is refused by name (A8c), as is a mesh of another package."""
    from tony_tpu_torch.parallel.collectives import DeviceRing

    fsdp = TMesh.Mesh(shape={"stage": 1, "data": 1, "fsdp": 2, "expert": 1, "context": 1, "model": 1},
                      device=torch.device("cpu"), ring=DeviceRing(1, "cpu"))
    params = TMlp.init(torch.Generator().manual_seed(0), TMlp.MLPConfig(), "cpu")
    with pytest.raises(NotImplementedError, match="A8c"):
        TMlp.forward(params, torch.zeros(1, 784), TMlp.MLPConfig(), mesh=fsdp)
    rp, rs = TR.init(torch.Generator().manual_seed(0), TR.RESNET_TINY, "cpu")
    batch = TR.synthetic_batch(torch.Generator().manual_seed(1), 2, TR.RESNET_TINY)
    with pytest.raises(NotImplementedError, match="A8c"):
        TR.forward(rp, rs, batch["image"], TR.RESNET_TINY, mesh=fsdp)


def test_the_take_equals_jaxs_one_hot_embedding_on_a_two_axis_mesh():
    """On ``data 2 × fsdp 2`` JAX's ``embed_lookup`` takes its one-hot
    product (two active axes); the port keeps the take: the same f32 bits."""
    mesh = JMesh.MeshSpec(data=2, fsdp=2).build(devices=jax.devices()[:4])
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((256, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (4, 16))
    want = np.asarray(JL.embed_lookup(jnp.asarray(embed), jnp.asarray(tokens), mesh))
    got = TL.embed_lookup(torch.from_numpy(embed), torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), want)
