"""Port parity, the layout arithmetic on its own: the rank grid and the
tp/dp groups against the JAX package's mesh, the placement builders and
every parameter's placement against the reference's PartitionSpecs, the
per-dim meet, the moment placement of ZeRO, and the train-mode refusals."""

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from galvatron_tpu.config import strategy as JC
from galvatron_tpu.models import base as JM
from galvatron_tpu.parallel import mesh as JMESH
from galvatron_tpu.parallel import spec as JS
from galvatron_tpu.runtime import optimizer as JO
from galvatron_tpu_torch.config import strategy as TC
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.parallel import mesh as TMESH
from galvatron_tpu_torch.parallel import spec as TS
from galvatron_tpu_torch.runtime import optimizer as TO
from galvatron_tpu_torch.runtime.model_api import check_layout


def _norm(p, ndim=None):
    """A PartitionSpec as the port's placement: a tuple of axis tuples."""
    out = []
    for e in p:
        out.append(() if e is None else ((e,) if isinstance(e, str) else tuple(e)))
    if ndim is not None:
        out += [()] * (ndim - len(out))
    return tuple(out)


def _pair(world, **kw):
    layers = kw.pop("layers", None)
    if layers is None:
        return JC.HybridParallelConfig.uniform(world, 4, **kw), \
            TC.HybridParallelConfig.uniform(world, 4, **kw)
    return (JC.HybridParallelConfig(world_size=world, pp=1,
                                    layers=[JC.LayerStrategy(**s) for s in layers], **kw),
            TC.HybridParallelConfig(world_size=world, pp=1,
                                    layers=[TC.LayerStrategy(**s) for s in layers], **kw))


@pytest.mark.parametrize("consec,want", [(1, [[0, 1], [2, 3]]), (0, [[0, 2], [1, 3]])])
def test_tp_and_dp_groups_at_world_four_match_the_reference_mesh(consec, want):
    """tp_consec=1 puts tp on the minor sub-axis ({0,1},{2,3}); tp_consec=0
    on the major one ({0,2},{1,3}), as the reference's _assign does; dp
    takes the rest. The port's group over a layer's axes holds the ranks
    that share the reference mesh's other coordinates."""
    j, t = _pair(4, layers=[dict(tp=2, tp_consec=consec)] * 4)
    jax_axes, port_axes = JMESH.layer_axes(j, 0), TMESH.layer_axes(t, 0)
    assert (port_axes.tp, port_axes.dp) == (jax_axes.tp, jax_axes.dp)
    mesh = JMESH.build_mesh(j, jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    names = mesh.axis_names
    for role, axes in (("tp", port_axes.tp), ("dp", port_axes.dp)):
        groups = set()
        for rank in range(4):
            rm = TMESH.RankMesh(t, rank)
            assert rm.shape == tuple(mesh.devices.shape)
            mine = rm.ranks(axes)
            # the reference: devices sharing this rank's coordinates off `axes`
            coord = np.argwhere(ids == ids.flat[rank])[0]
            sel = tuple(slice(None) if n in axes else int(c) for n, c in zip(names, coord))
            assert list(mine) == [int(x) for x in ids[sel].reshape(-1)]
            assert rank in mine and rm.index(axes) == mine.index(rank)
            groups.add(tuple(mine))
        if role == "tp":
            assert sorted(groups) == [tuple(g) for g in want]


def test_rank_grid_is_row_major_and_indexes_axes_major_first():
    _, t = _pair(8)
    rm = TMESH.RankMesh(t, 6)
    assert rm.shape == (1, 2, 2, 2) and rm.coord == {"pp": 0, "m0": 1, "m1": 1, "m2": 0}
    assert rm.ranks(("m0", "m2")) == (2, 3, 6, 7)
    assert rm.index(("m0", "m2")) == 2 and rm.index(("m1",)) == 1 and rm.index(()) == 0
    assert rm.size(("m0", "m1")) == 4 and rm.size(()) == 1
    assert len(rm.axis_subsets()) == 8  # every subset of m0..m2, the empty one included
    with pytest.raises(ValueError, match="grid order"):
        rm.index(("m1", "m0"))


def test_groups_need_the_callers_process_group_even_at_world_one():
    """`group_for` never creates the default group: outside
    `process_group` it raises and leaves none behind; inside, a world-1
    mesh built before the group finds its one-rank groups, and the group
    is gone on the way out."""
    import torch.distributed as dist

    from galvatron_tpu_torch.runtime import distributed

    _, t = _pair(1)
    rm = TMESH.RankMesh(t, 0, "cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process_group"):
        rm.group_for(())
    assert not dist.is_initialized()
    with distributed.process_group("cpu"):
        assert dist.get_world_size(rm.group_for(rm.names[1:])) == 1
    assert not dist.is_initialized()


_STRATEGIES = {
    "dp8": dict(),
    "zero3": dict(sdp=1),
    "tp2": dict(tp=2),
    "tp4_nonconsec_zero2": dict(layers=[dict(tp=4, tp_consec=0)] * 4, default_dp_type="zero2"),
    "vtp2_embed_sdp": dict(vocab_tp=2, embed_sdp=1, tp=2),
    "hetero": dict(layers=[dict(tp=2), dict(tp=4, fsdp=1), dict(fsdp=1), dict(checkpoint=1)],
                   default_dp_type="zero2"),
    "no_sp_tp8": dict(tp=8, sequence_parallel=False),
}
_MODELS = {
    "gpt": dict(hidden_size=64, num_heads=8, num_layers=4, vocab_size=128, max_seq_len=64),
    "llama": dict(hidden_size=64, num_heads=8, num_kv_heads=8, num_layers=4,
                      vocab_size=128, max_seq_len=64, norm_type="rmsnorm",
                      activation="swiglu", position_type="rope", tie_embeddings=False,
                      qkv_bias=False, mlp_bias=False, out_bias=False),
}


def _flat_specs(tree, is_leaf=lambda x: isinstance(x, P)):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[name] = leaf
    return out


@pytest.mark.parametrize("model", sorted(_MODELS))
@pytest.mark.parametrize("name", sorted(_STRATEGIES))
def test_every_parameter_placement_matches_the_reference_spec(name, model):
    import jax.numpy as jnp
    import torch

    j, t = _pair(8, **_STRATEGIES[name])
    jcfg = JM.TransformerConfig(**_MODELS[model], compute_dtype=jnp.float32)
    tcfg = TM.TransformerConfig(**_MODELS[model], compute_dtype=torch.float32)
    want = {n: _norm(s) for n, s in _flat_specs(JM.model_param_specs(jcfg, j)).items()}
    shapes = dict(TM.TransformerLM(tcfg, "meta").named_parameters())
    got = TM.model_param_specs(tcfg, t)
    assert sorted(got) == sorted(want)
    for n in want:
        ndim = shapes[n].dim()
        assert TS._pad(got[n], ndim) == _norm(want[n], ndim), n


@pytest.mark.parametrize("name", sorted(_STRATEGIES))
def test_zero_moment_placement_matches_the_reference(name):
    """ZeRO-1/2 put the dp axes on the first unsharded dim that divides
    (the reference's _shard_moment_spec, which never pads)."""
    import jax.numpy as jnp
    import torch

    j, t = _pair(8, **_STRATEGIES[name])
    jcfg = JM.TransformerConfig(**_MODELS["gpt"], compute_dtype=jnp.float32)
    tcfg = TM.TransformerConfig(**_MODELS["gpt"], compute_dtype=torch.float32)
    jspecs = _flat_specs(JM.model_param_specs(jcfg, j))
    layouts = TM.model_param_layouts(tcfg, t)
    rm = TMESH.RankMesh(t, 0)
    for n, p in TM.TransformerLM(tcfg, "meta").named_parameters():
        pl = layouts[n]
        zax = pl.dp if pl.zero_opt else ()
        want = JO._shard_moment_spec(jspecs[n], tuple(p.shape), zax, dict(rm.sizes))
        dim = TO.moment_dim(pl.spec, tuple(p.shape), rm.size(pl.dp), pl.zero_opt,
                            pl.z3_dim is not None)
        assert TO.moment_spec(pl.spec, p.dim(), dim, pl.dp) == _norm(want, p.dim()), n


@pytest.mark.parametrize("a,b", [
    (P(("m0", "m1"), None, None), P("m0", "m1", None)),
    (P("m0", "m1", None), P(None, ("m0", "m1"), None)),
    (P(("m0", "m1", "m2"), None), P(("m0", "m2"), "m1")),
    (P("m1", None), P("m1", None)),
    (P(), P("m0", None)),
])
def test_meet_matches_the_reference(a, b):
    assert TS.meet_spec(_norm(a), _norm(b), 3) == _norm(JS.meet_spec(a, b, 3), 3)


def test_placement_builders_match_the_reference():
    j, t = _pair(8, layers=[dict(tp=2, fsdp=1)] * 4, vocab_tp=4, embed_sdp=1)
    for jax_axes, port_axes in ((JMESH.layer_axes(j, 0), TMESH.layer_axes(t, 0)),
                                (JMESH.vocab_axes(j), TMESH.vocab_axes(t))):
        for fn in ("act_spec", "logits_spec", "col_kernel_spec", "row_kernel_spec",
                   "col_bias_spec", "replicated_1d_spec", "vocab_embed_spec"):
            want = getattr(JS, fn)(jax_axes)
            got = getattr(TS, fn)(port_axes)
            assert TS._pad(got, 3) == _norm(want, 3), fn


@pytest.mark.parametrize("kw,item", [
    (dict(pp=2, cp=2), "1F1B engine"), (dict(cp=2), None), (dict(tp=2, sp=1), None),
    (dict(vocab_tp=2, vocab_sp=1), None), (dict(vocab_cp=2), None),
    (dict(tp=2, tp_comm_mode="overlap"), "item 10"),
])
def test_train_refuses_what_this_slice_does_not_run_naming_its_item(kw, item):
    """Long context runs (cp, Ulysses, vocab sp and cp); cp under GPipe is
    refused with the reference engine's message, the manual TP modes with
    their ROADMAP item."""
    hp = TC.HybridParallelConfig.uniform(4, 4, **kw)
    if item is None:
        check_layout(hp)
        return
    with pytest.raises(ValueError, match=item):
        check_layout(hp)


@pytest.mark.parametrize("name", ["zero3", "tp4_nonconsec_zero2", "hetero", "vtp2_embed_sdp"])
def test_zero_axes_tree_matches_the_reference(name):
    """Per parameter, the dp axes its Adam moments shard over."""
    import jax.numpy as jnp
    import torch

    from galvatron_tpu.runtime import model_api as JAPI
    from galvatron_tpu_torch.runtime import model_api as TAPI

    j, t = _pair(8, **_STRATEGIES[name])
    jcfg = JM.TransformerConfig(**_MODELS["gpt"], compute_dtype=jnp.float32)
    tcfg = TM.TransformerConfig(**_MODELS["gpt"], compute_dtype=torch.float32)
    want = _flat_specs(JAPI.construct_hybrid_parallel_model(jcfg, j, jax.devices()).zero_axes_tree(),
                       is_leaf=lambda x: isinstance(x, tuple))
    model = TAPI.HybridParallelModel(cfg=tcfg, hp=t, device=torch.device("cpu"),
                                     mesh=TMESH.RankMesh(t, 3),
                                     param_layouts=TM.model_param_layouts(tcfg, t))
    assert model.zero_axes_tree() == want
