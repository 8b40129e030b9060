"""The port's sharding metadata against the JAX package's, on the CPU.

Every spec is compared exactly, as plain tuples: ``tuple(P(...))`` on the
JAX side. The JAX parameter specs come from ``init`` under
``jax.eval_shape`` (the side channel of ``repro.launch.dryrun``'s
``abstract_params``, which is not imported: importing it sets 512 virtual
devices), the port's from its model on the ``meta`` device, so neither
package allocates a published-size model. The JAX state shardings and
``shardings_for`` run on ``AbstractMesh``es of the production shapes.
"""

import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models.registry import build as jax_build
from repro.train.elastic import shardings_for as jax_shardings_for
from repro.train.optimizer import zero1_specs as jax_zero1_specs
from repro.train.trainer import make_state_shardings as jax_state_shardings
from repro_torch.comm import grid_coords, shard_slices
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, get_smoke_config
from repro_torch.launch.mesh import dp_axes_of, make_production_mesh
from repro_torch.models import convert
from repro_torch.models.moe import MoE, local_params
from repro_torch.models.registry import build, meta_params
from repro_torch.train.elastic import shardings_for
from repro_torch.train.optimizer import zero1_specs
from repro_torch.train.trainer import make_state_shardings

GRIDS = {"single": ((16, 16), ("data", "model")),
         "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _is_p(x):
    return isinstance(x, P)


def _plain(tree):
    """A JAX spec tree with every ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=_is_p)


@functools.lru_cache(maxsize=None)
def _jax_init_specs(cfg):
    """``(model, shapes, specs)``: the JAX package's model and its
    ``init``'s shapes and specs with no allocation, as
    ``abstract_params`` captures them (traced once a config)."""
    box = {}
    model = jax_build(cfg)

    def init_only(key):
        params, specs = model.init(key)
        box["specs"] = specs
        return params

    sds = jax.eval_shape(init_only, jax.random.PRNGKey(0))
    return model, sds, box["specs"]


def _by_port_name(tree, cfg):
    """A JAX tree as ``{port name: leaf}`` in its own leaf order: a stacked
    collection's leaf split into its layers (a spec loses its leading
    layer entry, which must be None), one after another."""
    layers = {"blocks": cfg.num_layers, "dec_blocks": cfg.num_layers,
              "enc_blocks": cfg.enc_layers}

    def leaves(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    out = {}
    for key in sorted(tree):
        v = tree[key]
        if key in convert.BLOCKS and isinstance(v, list):
            for i, block in enumerate(v):
                for name, leaf in leaves(block, ""):
                    out[f"{key}.{i}.{name}"] = leaf
        elif key in convert.BLOCKS:
            for name, leaf in leaves(v, ""):
                for i in range(layers[key]):
                    out[f"{key}.{i}.{name}"] = leaf
        elif isinstance(v, dict):
            out.update(leaves(v, f"{key}."))
        else:
            out[key] = v
    return out


def _unstack_specs(named, cfg):
    stacked = convert.stacked_collections(cfg)
    out = {}
    for name, spec in named.items():
        spec = tuple(spec)
        if name.split(".")[0] in stacked:
            assert spec[0] is None, (name, spec)
            spec = spec[1:]
        out[name] = spec
    return out


def test_every_arch_is_ported():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)


@pytest.mark.parametrize("size", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax_leaf_for_leaf(arch, size):
    """``Model.param_specs()`` equals the JAX ``init``'s specs name for
    name in ``convert.named_leaves`` order, trailing Nones included."""
    cfg = get_config(arch) if size == "published" else get_smoke_config(arch)
    jcfg = (jax_get_config(arch) if size == "published"
            else jax_smoke_config(arch))
    _, _, jspecs = _jax_init_specs(jcfg)
    want = _unstack_specs(_by_port_name(jspecs, jcfg), jcfg)
    got = build(cfg).param_specs()
    assert list(got.items()) == list(want.items())
    # the port's own leaf order is the one its parameters are listed in
    assert list(got) == list(convert.named_leaves(meta_params(cfg), cfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tree_is_the_jax_spec_tree(arch):
    """Laid out as the JAX tree, stacked leaves led by None."""
    _, _, jspecs = _jax_init_specs(jax_get_config(arch))
    cfg = get_config(arch)
    assert convert.spec_tree(build(cfg).param_specs(), cfg) == _plain(jspecs)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_jax(arch, shape_name):
    """Both default batch axes and one: the inputs' specs and the caches'
    layout of specs (a stacked dict or a list of per-layer dicts)."""
    jm = jax_build(jax_get_config(arch))
    m = build(get_config(arch))
    for dp in (("pod", "data"), ("data",)):
        assert m.batch_specs(shape_name, dp) == _plain(
            jm.batch_specs(shape_name, dp))
        assert m.cache_specs(shape_name, dp) == _plain(
            jm.cache_specs(shape_name, dp))
    assert m.batch_specs(shape_name) == _plain(jm.batch_specs(shape_name))
    assert m.cache_specs(shape_name) == _plain(jm.cache_specs(shape_name))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_zero1_specs_equal_jax_on_the_production_grids(grid):
    shape, axes = GRIDS[grid]
    sizes = dict(zip(axes, shape))
    for arch in ARCH_IDS:
        jcfg = jax_get_config(arch)
        _, sds, jspecs = _jax_init_specs(jcfg)
        jz = jax_zero1_specs(jspecs, sds, ("data",), sizes)
        want = _unstack_specs(_by_port_name(_plain(jz), jcfg), jcfg)
        m = build(get_config(arch))
        shapes = {n: tuple(s.shape) for n, s in
                  _by_port_name(sds, jcfg).items()}
        stacked = convert.stacked_collections(jcfg)
        shapes = {n: s[1:] if n.split(".")[0] in stacked else s
                  for n, s in shapes.items()}
        assert zero1_specs(m.param_specs(), shapes, ("data",),
                           sizes) == want, arch


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_state_specs_equal_jax_state_shardings(grid, master):
    """``make_state_shardings`` gives the specs of the JAX package's
    NamedShardings (on an ``AbstractMesh`` of the grid's shape) for the
    parameters, ``m``, ``v``, ``step`` and ``master``."""
    g = make_production_mesh(multi_pod=grid == "multi_pod")
    assert (g.shape, g.axes) == GRIDS[grid]
    mesh = AbstractMesh(g.shape, g.axes)
    for arch in ("qwen2_moe_a2_7b", "tinyllama_1_1b", "whisper_small",
                 "zamba2_1_2b"):
        jcfg = jax_get_config(arch)
        jm, _, jspecs = _jax_init_specs(jcfg)
        jp, jo = jax_state_shardings(jm, mesh, jspecs, master=master)
        spec_of = lambda t: jax.tree.map(                   # noqa: E731
            lambda s: tuple(s.spec), t,
            is_leaf=lambda x: isinstance(x, NamedSharding))
        p, o = make_state_shardings(build(get_config(arch)), g.sizes,
                                    master=master)
        assert p == _unstack_specs(_by_port_name(spec_of(jp), jcfg), jcfg)
        assert set(o) == set(jo)
        assert o["step"] == tuple(jo["step"].spec) == ()
        for key in set(o) - {"step"}:
            assert o[key] == _unstack_specs(
                _by_port_name(spec_of(jo[key]), jcfg), jcfg), (arch, key)


def test_zero1_without_a_data_axis_keeps_the_parameter_specs():
    m = build(get_config("tinyllama_1_1b"))
    p, o = make_state_shardings(m, {"model": 16})
    assert o["m"] == o["v"] == p
    p, o = make_state_shardings(m, {"data": 16, "model": 16}, zero1=False)
    assert o["m"] == p


def test_shardings_for_drops_the_axes_a_grid_lacks():
    """The multi-pod state specs restored onto the single-pod grid: ``pod``
    goes, from names and from tuples, as the JAX filter does."""
    g = make_production_mesh()
    mesh = AbstractMesh(g.shape, g.axes)
    jm, _, jspecs = _jax_init_specs(jax_get_config("qwen2_moe_a2_7b"))
    jz = jax_zero1_specs(jspecs, jax.eval_shape(
        lambda k: jm.init(k)[0], jax.random.PRNGKey(0)), ("pod", "data"),
        {"pod": 2, "data": 16})
    cases = {"zero1": jz, "batch": jm.batch_specs("train_4k"),
             "cache": jm.cache_specs("long_500k"),
             "extra": {"a": P(("pod", "data"), "model"), "b": P("pod", None),
                       "c": P(("pod",), None)}}
    for name, tree in cases.items():
        want = jax.tree.map(lambda s: tuple(s.spec),
                            jax_shardings_for(mesh, tree),
                            is_leaf=lambda x: isinstance(x, NamedSharding))
        assert shardings_for(g.axes, _plain(tree)) == want, name
    assert shardings_for(("data",), {"x": (("pod", "data"), None),
                                     "y": [("pod",), ("model",)]}) == {
        "x": ("data", None), "y": [(None,), (None,)]}


def test_production_grids_are_data_not_ranks():
    g1, g2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert g1 == ((16, 16), ("data", "model"))
    assert g2 == ((2, 16, 16), ("pod", "data", "model"))
    assert g2.sizes == {"pod": 2, "data": 16, "model": 16}
    assert dp_axes_of(g1) == ("data",)
    assert dp_axes_of(g2) == ("pod", "data")


SHARD_CASES = [
    ((64, 32), (("pod", "data"), "model")),
    ((64, 32), ("model", None)),
    ((64, 32), (None, ("model", "pod"))),
    ((32,), ("data",)),
    ((16, 8, 4), ("model", None, None)),
    ((16, 8, 4), (None,)),
    ((4, 4), ()),
]


@pytest.mark.parametrize("shape,spec", SHARD_CASES, ids=str)
def test_shard_slices_match_named_sharding_shard_shapes(shape, spec):
    """On the ``(2, 4, 4)`` ``("pod", "data", "model")`` grid: every rank's
    block has ``NamedSharding``'s shard shape, and the blocks of the ranks
    tile the array, each element held by as many ranks as the spec leaves
    the array replicated over."""
    gshape, axes = (2, 4, 4), ("pod", "data", "model")
    want = NamedSharding(AbstractMesh(gshape, axes),
                         P(*spec)).shard_shape(shape)
    cover = torch.zeros(shape, dtype=torch.int32)
    for rank in range(32):
        sl = shard_slices(shape, spec, gshape, axes, rank)
        assert tuple(cover[sl].shape) == tuple(want)
        cover[sl] += 1
    named = {a for e in spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)}
    repl = 32 // torch.tensor([s for a, s in zip(axes, gshape)
                               if a in named]).prod().item()
    assert bool((cover == repl).all())


def test_shard_slices_index_is_row_major_in_the_entrys_order():
    gshape, axes = (2, 4), ("dc", "node")
    for rank in range(8):
        g, i = grid_coords(gshape, rank)
        assert (g, i) == divmod(rank, 4)
        assert shard_slices((16,), (("dc", "node"),), gshape, axes,
                            rank)[0] == slice(2 * rank, 2 * rank + 2)
        assert shard_slices((16,), (("node", "dc"),), gshape, axes,
                            rank)[0] == slice(2 * (i * 2 + g),
                                              2 * (i * 2 + g) + 2)
    with pytest.raises(ValueError, match="split"):
        shard_slices((6,), ("node",), gshape, axes, 0)
    with pytest.raises(ValueError, match="axis"):
        shard_slices((8,), ("model",), gshape, axes, 0)


class _OneRank:
    """What ``local_params`` reads of a process's ranks."""

    def __init__(self, shape, axes, rank):
        self.shape, self.axes, self.rank = shape, axes, rank

    def local_shard(self, t, spec):
        return t[shard_slices(t.shape, spec, self.shape, self.axes,
                              self.rank)]


def test_local_params_cut_each_process_its_experts():
    """Qwen1.5-MoE's 64 padded experts on ``(1, 8)``: rank ``me`` holds
    experts ``8 me .. 8 me + 7`` of the three routed weights, the router
    and the shared experts whole."""
    cfg = get_smoke_config("qwen2_moe_a2_7b")
    moe = MoE(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    moe.init_weights(gen)
    params = dict(moe.named_parameters())
    e_pad = params["w_gate"].shape[0]
    for me in range(8):
        local = local_params(params, moe.specs, _OneRank((1, 8),
                                                         ("data", "model"),
                                                         me))
        assert set(local) == set(params)
        e_loc = e_pad // 8
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(local[name],
                               params[name][me * e_loc:(me + 1) * e_loc])
        for name in set(params) - {"w_gate", "w_up", "w_down"}:
            assert local[name] is params[name]
