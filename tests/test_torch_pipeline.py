"""Port parity, pipelines in one process (``LocalTransport``).

Every stage of a strategy whose stages hold one device each runs in this
process (hand-offs are clones), fp32 on the CPU, on the tiny models and the
uneven-mask batch of ``tests/test_torch_parallel.py`` (whose gloo worlds
run the same pipelines one stage per rank):

- the port's validators accept and refuse exactly the strategies the JAX
  package's ``validate_pipeline_config`` / ``validate_1f1b_config`` do;
- the per-stage GPipe and 1F1B orders: every micro-batch's forward before
  its backward on each stage, at most ``pp - s`` in flight on stage ``s``
  under 1F1B, neighbours' exchanges pairing up batch by batch, and, run
  through the transport, activations going stage s-1 -> s and cotangents
  s+1 -> s;
- ``tools.from_jax`` reads the JAX package's stacked ``stages`` trees (even
  and uneven divisions), the inverse of its ``stack_params``;
- GPipe at pp 2 and 4 against the JAX package's ``make_pipelined_loss`` on
  the conftest's virtual devices, 1F1B (pp 2, pp 4 divided 2,2,1,1, and
  heterogeneous stages) against its unsharded loss and gradients: loss
  within 2e-5, every gradient within 1e-4 * max|g| + 1e-6, and three train
  steps against optax within the trajectory limits (losses 5e-5; params
  and moments 5e-5 of their tree's max);
- the train parser accepts a reference command line's
  ``--distributed_checkpoint``.
"""

import numpy as np
import pytest

import jax
import torch

from galvatron_tpu.analysis.diagnostics import DiagnosticError as JDiagErr
from galvatron_tpu.cli import arguments as JARGS
from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.config.strategy import LayerStrategy as JLS
from galvatron_tpu.models import base as JM
from galvatron_tpu.models.llama import llama_config as j_llama_config
from galvatron_tpu.parallel import pipeline as JPL
from galvatron_tpu.parallel import pipeline_1f1b as J1F1B
from galvatron_tpu.runtime import dataloader as JD
from galvatron_tpu.runtime import model_api as JAPI
from galvatron_tpu.runtime import optimizer as JO
from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError as TDiagErr
from galvatron_tpu_torch.cli import arguments as TARGS
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.models.llama import llama_config as t_llama_config
from galvatron_tpu_torch.parallel import pipeline as TPL
from galvatron_tpu_torch.parallel import pipeline_1f1b as T1F1B
from galvatron_tpu_torch.runtime import distributed as TDIST
from galvatron_tpu_torch.runtime.dataloader import prepare_batch
from galvatron_tpu_torch.runtime.model_api import check_layout, construct_hybrid_parallel_model
from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs, get_optimizer_and_scheduler
from galvatron_tpu_torch.tools.from_jax import _flatten, params_from_numpy
from tests.test_torch_parallel import (
    B,
    GPT,
    LLAMA6,
    LOSS_TOL,
    OPT,
    TRAJ_STEPS,
    TRAJ_TOL,
    batch_np,
    grad_errors,
)

MODELS = {"gpt": GPT, "llama6": LLAMA6}


def _jcfg(model):
    import jax.numpy as jnp

    if model == "gpt":
        return JM.TransformerConfig(**GPT, compute_dtype=jnp.float32)
    return j_llama_config("llama-0.3b", compute_dtype=jnp.float32, **LLAMA6)


def _tcfg(model):
    if model == "gpt":
        return TM.TransformerConfig(**GPT, compute_dtype=torch.float32)
    return t_llama_config("llama-0.3b", compute_dtype=torch.float32, **LLAMA6)


def _pair(world, layers, **kw):
    """The same strategy in both packages (layers: LayerStrategy kwargs)."""
    kw.setdefault("global_bsz", B)
    return (JHP(world_size=world, layers=[JLS(**s) for s in layers], **kw),
            THP(world_size=world, layers=[TLS(**s) for s in layers], **kw))


# ================================================================= validation
_L = dict
GP, OF = dict(pipeline_type="gpipe"), dict(pipeline_type="pipedream_flush")
VALIDATION = {
    "even_uniform_gpipe": (2, [_L()] * 4, dict(pp=2, chunks=2, **GP)),
    "uneven_gpipe": (2, [_L()] * 4, dict(pp=2, pp_division=[3, 1], chunks=2, **GP)),
    "uneven_1f1b": (2, [_L()] * 4, dict(pp=2, pp_division=[3, 1], chunks=2, **OF)),
    "pp4_2211_1f1b": (4, [_L()] * 6, dict(pp=4, pp_division=[2, 2, 1, 1], chunks=4, **OF)),
    "pp4_2211_gpipe": (4, [_L()] * 6, dict(pp=4, pp_division=[2, 2, 1, 1], chunks=4, **GP)),
    "slots_differ_gpipe": (4, [_L(tp=2), _L(tp=2), _L(), _L()], dict(pp=2, chunks=2, **GP)),
    "slots_differ_1f1b": (4, [_L(tp=2), _L(tp=2), _L(), _L()], dict(pp=2, chunks=2, **OF)),
    "remat_differs_gpipe": (2, [_L(checkpoint=1), _L(), _L(), _L()], dict(pp=2, chunks=2, **GP)),
    "slots_match_gpipe": (2, [_L(checkpoint=1), _L(fsdp=1)] * 2, dict(pp=2, chunks=2, **GP)),
    "cp_gpipe": (4, [_L(cp=2)] * 4, dict(pp=2, chunks=2, **GP)),
    "cp_uniform_1f1b": (4, [_L(cp=2)] * 4, dict(pp=2, chunks=2, **OF)),
    "cp_hetero_1f1b": (4, [_L(cp=2), _L(), _L(), _L()], dict(pp=2, chunks=2, **OF)),
    "bsz_chunks_gpipe": (2, [_L()] * 4, dict(pp=2, chunks=3, **GP)),
    "bsz_chunks_1f1b": (2, [_L()] * 4, dict(pp=2, chunks=3, **OF)),
    "empty_stage_1f1b": (2, [_L()] * 4, dict(pp=2, pp_division=[4, 0], chunks=2, **OF)),
}


def _outcome(hp_cls, layer_cls, err, validate, world, layers, kw):
    """("config", codes) if the strategy does not construct; ("refused",
    the message's first 40 characters) if the validator refuses; "ok"."""
    try:
        hp = hp_cls(world_size=world, layers=[layer_cls(**s) for s in layers], global_bsz=B,
                    **kw)
    except err as e:
        return ("config", sorted(d.code for d in e.diagnostics)), None
    try:
        validate(hp)
    except ValueError as e:
        return ("refused", str(e)[:40]), hp
    return "ok", hp


@pytest.mark.parametrize("name", sorted(VALIDATION))
def test_validators_refuse_what_the_reference_refuses(name):
    """The port's validator of the pipeline type gives the reference's
    outcome; ``check_layout`` refuses exactly those (cp under GPipe
    among them) and runs the rest (cp inside 1F1B among them)."""
    world, layers, kw = VALIDATION[name]
    one_f = kw["pipeline_type"] == "pipedream_flush"
    want, _ = _outcome(JHP, JLS, JDiagErr,
                       J1F1B.validate_1f1b_config if one_f else JPL.validate_pipeline_config,
                       world, layers, kw)
    got, hp = _outcome(THP, TLS, TDiagErr,
                       T1F1B.validate_1f1b_config if one_f else TPL.validate_pipeline_config,
                       world, layers, kw)
    assert got == want
    if hp is None:
        return
    if got == "ok":
        check_layout(hp)
    else:
        with pytest.raises(ValueError, match=got[1][:20]):
            check_layout(hp)


# ================================================================== schedules
ORDERS = {"gpipe": TPL.gpipe_order, "1f1b": T1F1B.one_f_one_b_order}
SCHEDULES = [(2, 2), (4, 8), (4, 2), (3, 5), (2, 1), (1, 3)]


@pytest.mark.parametrize("pp,chunks", SCHEDULES, ids=["pp%d-m%d" % c for c in SCHEDULES])
@pytest.mark.parametrize("kind", sorted(ORDERS))
def test_schedule_invariants(kind, pp, chunks):
    """Each stage runs every forward and backward once, a micro-batch's
    forward before its backward, at most ``pp - s`` micro-batches in flight
    on stage s under 1F1B (``chunks`` under GPipe); each exchange of stage
    s with s+1 pairs with one of s+1 with s, in the same order."""
    orders = {s: ORDERS[kind](pp, chunks, s) for s in range(pp)}
    for s, order in orders.items():
        fwd = [st.mb for st in order if st.kind == "F"]
        bwd = [st.mb for st in order if st.kind == "B"]
        assert sorted(fwd) == sorted(bwd) == list(range(chunks))
        live, peak, seen = 0, 0, set()
        for st in order:
            if st.kind == "F":
                live += 1
                seen.add(st.mb)
            elif st.kind == "B":
                assert st.mb in seen, (s, st)
                live -= 1
            peak = max(peak, live)
        assert peak <= (min(pp - s, chunks) if kind == "1f1b" else chunks), (s, peak)
    for s in range(pp - 1):
        up = [(tuple(m for k, m in st.sends if k == "fwd"), tuple(m for k, m in st.recvs
                                                                 if k == "bwd"))
              for st in orders[s] if st.kind == "X" and (
                  any(k == "fwd" for k, _ in st.sends) or any(k == "bwd" for k, _ in st.recvs))]
        down = [(tuple(m for k, m in st.recvs if k == "fwd"), tuple(m for k, m in st.sends
                                                                   if k == "bwd"))
                for st in orders[s + 1] if st.kind == "X" and (
                    any(k == "fwd" for k, _ in st.recvs) or any(k == "bwd" for k, _ in st.sends))]
        assert up == down, (s, up, down)


@pytest.mark.parametrize("pp,chunks", SCHEDULES, ids=["pp%d-m%d" % c for c in SCHEDULES])
@pytest.mark.parametrize("kind", sorted(ORDERS))
def test_local_transport_moves_forward_down_and_backward_up(kind, pp, chunks):
    """Through the transport, stage s receives micro-batch i's activation
    from stage s-1 after that stage's forward of it, and its cotangent from
    stage s+1 after that stage's backward of it."""
    events = []

    def forward(s, i, x):
        assert (x is None) == (s == 0)
        if x is not None:
            assert x[0].tolist() == [s - 1, i, 0] and ("F", s - 1, i) in events
        events.append(("F", s, i))
        return None if s == pp - 1 else (torch.tensor([s, i, 0]),)

    def backward(s, i, g):
        assert (g is None) == (s == pp - 1) and ("F", s, i) in events
        if g is not None:
            assert g[0].tolist() == [s + 1, i, 1] and ("B", s + 1, i) in events
        events.append(("B", s, i))
        return None if s == 0 else (torch.tensor([s, i, 1]),)

    orders = {s: ORDERS[kind](pp, chunks, s) for s in range(pp)}
    TPL.LocalTransport(pp).run(orders, forward, backward,
                               lambda i, s: [((3,), torch.int64)])
    assert sorted(events) == sorted((k, s, i) for k in "FB" for s in range(pp)
                                    for i in range(chunks))


# ================================================================= JAX trees
@pytest.mark.parametrize("div", [[2, 2], [3, 1], [2, 2, 1, 1], [1, 2, 3]])
def test_from_jax_reads_stacked_stages_and_round_trips(div):
    """A JAX ``stages`` tree (zero-padded trailing slots under an uneven
    division) reads back into the canonical state dict, and the port's
    unstack inverts the reference's stack."""
    n = sum(div)
    model = "gpt" if n == 4 else "llama6"
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(0), _jcfg(model)))
    jhp, thp = _pair(len(div), [_L()] * n, pp=len(div), pp_division=div, chunks=2,
                     pipeline_type="pipedream_flush")
    stacked = jax.device_get(JPL.stack_params(tree["layers"], jhp))
    jtree = {k: v for k, v in tree.items() if k != "layers"}
    jtree["stages"] = stacked
    got, want = params_from_numpy(jtree, hp=thp), params_from_numpy(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    ours, theirs = {}, {}
    _flatten(TPL.unstack_params(stacked, thp), "", ours)
    _flatten(jax.device_get(tree["layers"]), "", theirs)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)


def test_from_jax_refuses_stages_without_a_strategy():
    with pytest.raises(ValueError, match="pass hp"):
        params_from_numpy({"stages": []})


# =============================================================== loss, grads
@pytest.fixture(scope="module")
def reference():
    """Per model: the JAX package's weights and unsharded loss and
    gradients (full batch), and its optax trajectories per chunks."""
    tokens, labels, loss_mask = batch_np()
    jb = JD.prepare_batch(None, tokens, labels, loss_mask)
    out = {}
    for model in MODELS:
        cfg = _jcfg(model)
        tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(0), cfg))
        loss, grads = jax.value_and_grad(lambda p, _c=cfg: JM.lm_loss_fn(p, jb, _c))(tree)
        out[model] = dict(tree=tree, loss=float(loss),
                          grads={n: t.numpy() for n, t in params_from_numpy(
                              jax.device_get(grads)).items()},
                          weights=params_from_numpy(tree), traj={})
    return out


def _trajectory(reference, model, chunks):
    """The JAX package's three train steps on one device (cached)."""
    import optax

    ref = reference[model]
    if chunks in ref["traj"]:
        return ref["traj"][chunks]
    cfg = _jcfg(model)
    hp = JHP(world_size=1, pp=1, layers=[JLS()] * cfg.num_layers, global_bsz=B, chunks=chunks)
    m = JAPI.construct_hybrid_parallel_model(cfg, hp)
    tx, _ = JO.get_optimizer_and_scheduler(JO.OptimizerArgs(**OPT))
    params = jax.device_put(ref["tree"], m.shardings())
    state = m.init_opt_state(tx, params)
    step = m.make_train_step(tx, donate=False)
    tokens, labels, loss_mask = batch_np()
    jb = JD.prepare_batch(None, tokens, labels, loss_mask)
    losses = []
    for _ in range(TRAJ_STEPS):
        params, state, metrics = step(params, state, jb)
        losses.append(float(metrics["loss"]))
    adam = next(s for s in state if isinstance(s, optax.ScaleByAdamState))
    traj = {"loss": np.asarray(losses)}
    for kind, t in (("param", params), ("mu", adam.mu), ("nu", adam.nu)):
        traj.update({"%s/%s" % (kind, n): v.numpy()
                     for n, v in params_from_numpy(jax.device_get(t)).items()})
    ref["traj"][chunks] = traj
    return traj


def _port_loss_and_grads(model, thp, weights):
    tokens, labels, loss_mask = batch_np()
    with TDIST.process_group("cpu") as dev:
        m = construct_hybrid_parallel_model(_tcfg(model), thp, dev, transport="local")
        params = m.shard_params(weights)
        loss, grads = m.loss_and_grads(params, prepare_batch(None, tokens, labels, loss_mask,
                                                             device=dev))
        return float(loss), {n: g.numpy() for n, g in m.gather_grads(grads).items()}


def _check(loss, grads, want_loss, want_grads):
    assert abs(loss - want_loss) <= LOSS_TOL, (loss, want_loss)
    errs = grad_errors(grads, want_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1.0, "%s at %.3g of its limit" % (worst, errs[worst])


GPIPE = {
    2: [_L(checkpoint=1), _L()] * 2,
    4: [_L(checkpoint=1, remat_policy="dots_saveable")] * 4,
}


@pytest.mark.parametrize("pp", sorted(GPIPE))
def test_gpipe_matches_the_reference_gpipe(pp, reference):
    """The port's GPipe (every stage in this process) against the JAX
    package's ``make_pipelined_loss`` (one virtual device per stage) on the
    same weights, batch and strategy: the loss and every gradient."""
    jhp, thp = _pair(pp, GPIPE[pp], pp=pp, chunks=pp)
    ref = reference["gpt"]
    jm = JAPI.construct_hybrid_parallel_model(_jcfg("gpt"), jhp, jax.devices()[:pp])
    tree = {k: v for k, v in ref["tree"].items() if k != "layers"}
    tree["stages"] = JPL.stack_params(ref["tree"]["layers"], jhp)
    params = jax.device_put(tree, jm.shardings())
    tokens, labels, loss_mask = batch_np()
    jb = jm.shard_batch(JD.prepare_batch(None, tokens, labels, loss_mask))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(params, jb)
    want = {n: t.numpy() for n, t in params_from_numpy(jax.device_get(jgrads), hp=thp).items()}
    # the reference's pipeline computes its own unsharded function
    _check(float(jloss), want, ref["loss"], ref["grads"])
    loss, grads = _port_loss_and_grads("gpt", thp, ref["weights"])
    _check(loss, grads, float(jloss), want)


ONE_F = {
    "pp2": ("gpt", 2, [_L()] * 4, dict(chunks=4)),
    "pp4_uneven_2211": ("llama6", 4, [_L()] * 6, dict(pp_division=[2, 2, 1, 1], chunks=4)),
    "hetero_stages": ("gpt", 2, [_L(checkpoint=1), _L(fsdp=1, checkpoint=1,
                                                      remat_policy="dots_saveable"),
                                 _L(), _L(fsdp=1, checkpoint=1,
                                          remat_policy="nothing_saveable")],
                      dict(pp_division=[3, 1], chunks=2, default_dp_type="zero2")),
}


def _one_f(name):
    model, pp, layers, kw = ONE_F[name]
    return model, _pair(pp, layers, pp=pp, pipeline_type="pipedream_flush", **kw)[1]


@pytest.mark.parametrize("name", sorted(ONE_F))
def test_1f1b_matches_the_unsharded_reference(name, reference):
    model, thp = _one_f(name)
    ref = reference[model]
    loss, grads = _port_loss_and_grads(model, thp, ref["weights"])
    _check(loss, grads, ref["loss"], ref["grads"])


@pytest.mark.parametrize("name", sorted(ONE_F))
def test_1f1b_trajectory_matches_optax(name, reference):
    """Three train steps (clip, Adam, decay, the schedule): losses within
    5e-5, params and both moments within 5e-5 of their tree's max; a tied
    table's two copies stay bitwise equal."""
    model, thp = _one_f(name)
    want = _trajectory(reference, model, thp.chunks)
    tokens, labels, loss_mask = batch_np()
    with TDIST.process_group("cpu") as dev:
        m = construct_hybrid_parallel_model(_tcfg(model), thp, dev, transport="local")
        params = m.shard_params(reference[model]["weights"])
        tx, _ = get_optimizer_and_scheduler(OptimizerArgs(**OPT))
        state = m.init_opt_state(tx, params)
        step = m.make_train_step(tx, guard_anomalies=True)
        batch = prepare_batch(None, tokens, labels, loss_mask, device=dev)
        losses = []
        for _ in range(TRAJ_STEPS):
            params, state, metrics = step(params, state, batch)
            assert not metrics["anomalous"]
            losses.append(float(metrics["loss"]))
        got = {"param/" + n: t.numpy() for n, t in m.gather_params(params).items()}
        moments = m.gather_opt_state(state)
        got.update({"mu/" + n: t.numpy() for n, t in moments.mu.items()})
        got.update({"nu/" + n: t.numpy() for n, t in moments.nu.items()})
        if _tcfg(model).tie_embeddings:
            assert torch.equal(params[0].embed.wte, params[thp.pp - 1].embed.wte)
    np.testing.assert_allclose(losses, want["loss"], rtol=0, atol=TRAJ_TOL)
    for kind in ("param", "mu", "nu"):
        keys = [k for k in want if k.startswith(kind + "/")]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        errs = {k: float(np.abs(got[k] - want[k]).max()) for k in keys}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= TRAJ_TOL * scale, (worst, errs[worst], scale)


def test_pipelined_eval_loss_matches_the_reference(reference):
    """The forward-only pipeline (micro-batches weighted by valid tokens)
    gives the unsharded loss, on every stage's run."""
    model, thp = _one_f("pp4_uneven_2211")
    tokens, labels, loss_mask = batch_np()
    with TDIST.process_group("cpu") as dev:
        m = construct_hybrid_parallel_model(_tcfg(model), thp, dev, transport="local")
        loss = m.eval_loss(m.shard_params(reference[model]["weights"]),
                           prepare_batch(None, tokens, labels, loss_mask, device=dev))
    assert abs(float(loss) - reference[model]["loss"]) <= LOSS_TOL


def test_local_host_needs_one_device_per_stage():
    with TDIST.process_group("cpu") as dev:
        with pytest.raises(ValueError, match="one device"):
            construct_hybrid_parallel_model(_tcfg("gpt"), THP.uniform(4, 4, pp=2, chunks=2), dev,
                                            transport="local")


def test_a_checkpoint_view_needs_one_stage_per_process():
    """A rank file holds one stage: a process hosting every stage has no
    checkpoint view; one hosting a single stage gets its module."""
    with TDIST.process_group("cpu") as dev:
        hosted = construct_hybrid_parallel_model(_tcfg("gpt"), THP.uniform(2, 4, pp=2, chunks=2),
                                                 dev, transport="local")
        with pytest.raises(ValueError, match="one stage per rank"):
            hosted.checkpoint_view(hosted.init_params(0))
        one = construct_hybrid_parallel_model(_tcfg("gpt"), THP.uniform(1, 4, chunks=2), dev)
        params = one.init_params(0)
        assert one.checkpoint_view(params) == (params[0], None)


# ====================================================================== CLI
def test_reference_command_line_with_distributed_checkpoint_parses():
    argv = ["--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
            "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "128",
            "--seq_length", "32", "--pp_deg", "2", "--pipeline_type", "pipedream_flush",
            "--distributed_checkpoint", "1"]
    theirs = JARGS.build_parser("train").parse_args(argv)
    ours = TARGS.initialize_galvatron(argv=argv + ["--device", "cpu"], mode="train")
    assert ours.distributed_checkpoint == theirs.distributed_checkpoint == 1
    assert TARGS.initialize_galvatron(argv=argv[:-2], mode="train").distributed_checkpoint == 1
