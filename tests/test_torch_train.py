"""The port's training path against the reference's, on the CPU at reduced
qwen3-4b (2 layers, narrow widths): the same numpy inputs and the same
weights (carried across with ``params_from_numpy``) go through both
packages.

Bars: ``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
within 1e-5 in f32 (gradients relative to each leaf's largest value, floor
1) and, in bf16, the loss within 2e-2 and each gradient leaf within 5e-2 of
its largest value (bf16 rounds at other places in the two frameworks);
remat changes no value (bitwise); AdamW, its schedule and clipping within
1e-6 relative of the reference and 1e-5 of the numpy oracle of
tests/test_optim_sharding.py; int8-EF exact in its integers and within 1e-6
in its floats; the data batches bitwise; three train steps within 1e-5 in
the losses and the first moments and 1e-4 relative in the gradient norms
(the parameters have moved apart by then), the parameters after them as
``_compare_after_adam`` states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.model as ref_model
from repro.config import TrainConfig as RefTrainConfig
from repro.distributed import compression as ref_compression
from repro.train import optim as ref_optim
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.step import make_eval_step as ref_make_eval_step
from repro.train.step import make_train_step as ref_make_train_step
import repro_torch.configs as configs
from repro_torch.config import TrainConfig
from repro_torch.distributed import compression
from repro_torch.models import model
from repro_torch.train import optim, step
from repro_torch.train.data import SyntheticLM
from repro_torch.train.tree import flatten_with_path, leaves, map_tree

torch.set_num_threads(1)

B, S = 2, 16
LR = 1e-2                  # the train steps' learning rate


def _cfgs(**over):
    """(reference cfg, port cfg), equal field for field."""
    base = dict(n_layers=2, remat_policy="none", dtype="float32")
    base.update(over)
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config("qwen3-4b")), **base)
    mine = dataclasses.replace(configs.reduced(
        configs.get_config("qwen3-4b")), **base)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    return ref, mine


def _params(ref_cfg, cfg, seed=0):
    ref_p = ref_model.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, model.params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_p))


def _batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1                       # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_flat(tree):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): v for p, v in paths}


def _compare_trees(got, want, rel):
    """Every leaf of ``got`` (port) within ``rel`` x max(1, its largest
    reference value) of ``want`` (reference), paths equal."""
    mine = dict(flatten_with_path(got))
    ref = _ref_flat(want)
    assert mine.keys() == ref.keys()
    for k in ref:
        w = _np(ref[k])
        err = np.abs(_np(mine[k]) - w).max()
        assert err <= rel * max(1.0, np.abs(w).max()), (k, err)


def _compare_after_adam(got, want):
    """Parameters after AdamW steps at ``LR``: each leaf's mean difference
    within 1e-5, its largest within 0.2 x LR. Adam moves an element by
    ~LR x g / (|g| + eps): where g is near zero (a few elements in a
    thousand here) the two frameworks' ~2e-8 gradient difference is a large
    share of g and moves that element's step by a share of LR."""
    mine = dict(flatten_with_path(got))
    ref = _ref_flat(want)
    assert mine.keys() == ref.keys()
    for k in ref:
        d = np.abs(_np(mine[k]) - _np(ref[k]))
        assert d.mean() <= 1e-5 and d.max() <= 0.2 * LR, (k, d.mean(),
                                                          d.max())


def _port_value_and_grad(cfg, params, batch):
    """(loss, metrics, gradient tree) through the train step's leaves."""
    grads = map_tree(torch.zeros_like, params)
    tree = step.attach_grads(cfg, params, grads)
    loss, metrics = model.loss_fn(tree, cfg, batch)
    loss.backward()
    return loss.detach(), metrics, grads


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --- loss and gradients ---------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_grads_match_jax_f32(chunked, remat):
    ref_cfg, cfg = _cfgs(chunked_ce=chunked, ce_chunks=4,
                         remat_policy=remat)
    ref_p, p = _params(ref_cfg, cfg)
    batch = _batch(cfg)
    (want, aux), gwant = jax.value_and_grad(
        lambda q: ref_model.loss_fn(q, ref_cfg, jax.tree.map(
            jnp.asarray, batch)), has_aux=True)(ref_p)
    loss, metrics, grads = _port_value_and_grad(cfg, p, _torch_batch(batch))
    assert abs(float(loss) - float(want)) <= 1e-5
    assert abs(float(metrics["ce"]) - float(aux["ce"])) <= 1e-5
    _compare_trees(grads, gwant, 1e-5)


@pytest.mark.parametrize("chunked", [False, True])
def test_loss_and_grads_match_jax_bf16(chunked):
    ref_cfg, cfg = _cfgs(chunked_ce=chunked, ce_chunks=4, dtype="bfloat16",
                         remat_policy="full")
    ref_p, p = _params(ref_cfg, cfg)
    batch = _batch(cfg, seed=1)
    (want, _), gwant = jax.value_and_grad(
        lambda q: ref_model.loss_fn(q, ref_cfg, jax.tree.map(
            jnp.asarray, batch)), has_aux=True)(ref_p)
    loss, _, grads = _port_value_and_grad(cfg, p, _torch_batch(batch))
    assert abs(float(loss) - float(want)) <= 2e-2
    mine = dict(flatten_with_path(grads))
    for k, w in _ref_flat(gwant).items():
        w = _np(w)
        err = np.abs(_np(mine[k]) - w).max()
        assert err <= 5e-2 * np.abs(w).max(), (k, err)


@pytest.mark.parametrize("policy", ["minimal", "full"])
def test_remat_changes_no_value(policy):
    _, cfg = _cfgs(chunked_ce=True, ce_chunks=4)
    _, p = _params(*_cfgs())
    batch = _torch_batch(_batch(cfg, seed=2))
    base = _port_value_and_grad(cfg, p, batch)
    got = _port_value_and_grad(
        dataclasses.replace(cfg, remat_policy=policy), p, batch)
    assert torch.equal(base[0], got[0])
    for a, b in zip(leaves(base[2]), leaves(got[2])):
        assert torch.equal(a, b)


def test_gradients_land_in_the_stacked_buffer():
    """Each per-repeat view's gradient is a view of the stacked buffer, and
    the buffer equals the gradient of the stacked leaf."""
    _, cfg = _cfgs()
    _, p = _params(*_cfgs())
    batch = _torch_batch(_batch(cfg, seed=3))
    _, _, grads = _port_value_and_grad(cfg, p, batch)
    q = {k: v for k, v in p.items()}
    flat = [t.requires_grad_() for t in leaves(q)]
    loss, _ = model.loss_fn(q, cfg, batch)
    loss.backward()
    for a, t in zip(leaves(grads), flat):
        assert torch.allclose(a, t.grad, rtol=0, atol=1e-7)
        t.requires_grad_(False)


# --- optimizer --------------------------------------------------------------

def _np_adamw(p, g, m, v, step_, tc):
    """tests/test_optim_sharding.py's numpy oracle."""
    gn = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
    scale = min(1.0, tc.grad_clip / (gn + 1e-9))
    g = {k: x * scale for k, x in g.items()}
    out_p, out_m, out_v = {}, {}, {}
    warm = min(step_ / max(tc.warmup_steps, 1), 1.0)
    prog = np.clip((step_ - tc.warmup_steps) /
                   max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
    lr = tc.learning_rate * warm * (0.1 + 0.9 * 0.5 * (1 + np.cos(np.pi * prog)))
    bc1 = 1 - tc.b1 ** step_
    bc2 = 1 - tc.b2 ** step_
    for k in p:
        m2 = tc.b1 * m[k] + (1 - tc.b1) * g[k]
        v2 = tc.b2 * v[k] + (1 - tc.b2) * g[k] ** 2
        delta = (m2 / bc1) / (np.sqrt(v2 / bc2) + tc.eps) + tc.weight_decay * p[k]
        out_p[k] = p[k] - lr * delta
        out_m[k], out_v[k] = m2, v2
    return out_p, out_m, out_v


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("lr,clip", [(1e-2, 1.0), (3e-4, 0.05)])
def test_adamw_matches_reference_and_numpy_oracle(lr, clip):
    kw = dict(learning_rate=lr, warmup_steps=2, total_steps=10,
              grad_clip=clip)
    tc, ref_tc = TrainConfig(**kw), RefTrainConfig(**kw)
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = _t(p)
    jstate, tstate = ref_optim.init_opt_state(jp), optim.init_opt_state(tp)
    m0 = {k: np.zeros_like(v) for k, v in p.items()}
    np_p, np_m, np_v = p, m0, dict(m0)
    for s in (1, 2, 3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        jp, jstate, jm = ref_optim.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), jstate, ref_tc)
        tp, tstate, tm = optim.adamw_update(tp, _t(g), tstate, tc)
        np_p, np_m, np_v = _np_adamw(np_p, g, np_m, np_v, s, tc)
        assert int(tstate.step) == int(jstate.step) == s
        assert tstate.ef is None and jstate.ef is None
        for k in p:
            for got, ref in ((tp[k], jp[k]), (tstate.mu[k], jstate.mu[k]),
                             (tstate.nu[k], jstate.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-7)
            assert np.allclose(tp[k].numpy(), np_p[k], atol=1e-5), k
            assert np.allclose(tstate.mu[k].numpy(), np_m[k], atol=1e-6)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)


def test_lr_schedule_and_clip_match_reference():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=50)
    ref_tc = RefTrainConfig(learning_rate=1e-3, warmup_steps=5,
                            total_steps=50)
    for s in (0, 1, 4, 5, 6, 27, 49, 50, 80):
        got = float(optim.lr_schedule(torch.tensor(s, dtype=torch.int32), tc))
        want = float(ref_optim.lr_schedule(jnp.asarray(s, jnp.int32),
                                           ref_tc))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s
    rng = np.random.default_rng(1)
    g = {"x": rng.standard_normal((7, 3)).astype(np.float32) * 3,
         "y": [rng.standard_normal(4).astype(np.float32)]}
    jg, jn = ref_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg = {"x": torch.from_numpy(g["x"].copy()),
          "y": [torch.from_numpy(g["y"][0].copy())]}
    tg2, tn = optim.clip_by_global_norm(tg, 1.0)
    assert tg2 is tg                                  # scaled in place
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(optim.global_norm(tg)) == pytest.approx(1.0, rel=1e-5)
    np.testing.assert_allclose(tg["x"].numpy(), np.asarray(jg["x"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tg["y"][0].numpy(), np.asarray(jg["y"][0]),
                               rtol=1e-6)


def test_adamw_slices_change_no_value(monkeypatch):
    """The in-place update on slices gives the same bits as on whole
    leaves."""
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32)}
    g = {"w": rng.standard_normal((6, 5)).astype(np.float32)}
    outs = []
    for chunk in (optim.CHUNK, 7):
        monkeypatch.setattr(optim, "CHUNK", chunk)
        tp = _t(p)
        st = optim.init_opt_state(tp)
        tp, st, _ = optim.adamw_update(tp, _t(g), st, tc)
        outs.append((tp["w"], st.mu["w"], st.nu["w"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# --- gradient compression ---------------------------------------------------

def test_int8_ef_matches_reference_and_drops_ef_like_it():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((8, 4)).astype(np.float32),
         "b": [rng.standard_normal(6).astype(np.float32) * 1e-3]}
    jp = jax.tree.map(jnp.asarray, g)
    tp = {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]}
    jst = ref_optim.init_opt_state(jp, with_ef=True)
    tst = optim.init_opt_state(tp, with_ef=True)
    for _ in range(2):
        jd, jst = ref_compression.apply_int8_ef(jp, jst)
        td, tst = compression.apply_int8_ef(tp, tst)
        for path, w in _ref_flat(jd).items():
            got = dict(flatten_with_path(td))[path]
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-9)
        for path, w in _ref_flat(jst.ef).items():
            got = dict(flatten_with_path(tst.ef))[path]
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-9)
    q, s = compression._quantize(torch.from_numpy(g["a"]))
    jq, js = ref_compression._quantize(jnp.asarray(g["a"]))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                    np.asarray(jq))
    # AdamW returns a state without the error-feedback buffers, as the
    # reference does
    tc, ref_tc = TrainConfig(), RefTrainConfig()
    _, tst2, _ = optim.adamw_update(tp, td, tst, tc)
    _, jst2, _ = ref_optim.adamw_update(jp, jd, jst, ref_tc)
    assert tst2.ef is None and jst2.ef is None
    # compressed_psum on a world of 1 (gloo): one rank's quantized value,
    # bitwise the numpy oracle
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        got = compression.compressed_psum(torch.from_numpy(g["a"]), "data",
                                          mesh)
    finally:
        dist.destroy_process_group()
    scale = np.float32(np.abs(g["a"]).max()) / np.float32(127.0) + \
        np.float32(1e-12)
    want = np.clip(np.round(g["a"] / scale), -127, 127).astype(
        np.int32).astype(np.float32) * scale
    assert np.array_equal(got.numpy(), want)


# --- data --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "musicgen-medium",
                                  "llava-next-34b"])
def test_synthetic_lm_batches_bitwise(arch):
    cfg = configs.reduced(configs.get_config(arch))
    ref_cfg = ref_configs.reduced(ref_configs.get_config(arch))
    a, b = SyntheticLM(cfg, 4, 16, seed=5), RefSyntheticLM(ref_cfg, 4, 16,
                                                           seed=5)
    for s in (0, 3):
        x, y = a.global_batch(s), b.global_batch(s)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        h = a.host_batch(s, host_id=1, n_hosts=2)
        rh = b.host_batch(s, host_id=1, n_hosts=2)
        for k in h:
            assert np.array_equal(h[k], rh[k])


# --- train and eval steps ----------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("chunked", [False, True])
def test_three_train_steps_match_reference(microbatches, chunked):
    ref_cfg, cfg = _cfgs(chunked_ce=chunked, ce_chunks=4)
    ref_p, p = _params(ref_cfg, cfg)
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=10,
              num_microbatches=microbatches)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefTrainConfig(**kw)))
    my_step = step.make_train_step(cfg, TrainConfig(**kw))
    jst = ref_optim.init_opt_state(ref_p)
    tst = optim.init_opt_state(p)
    data = SyntheticLM(cfg, 4, S, seed=0)
    for s in range(3):
        batch = data.global_batch(s)
        ref_p, jst, jm = ref_step(ref_p, jst, jax.tree.map(jnp.asarray,
                                                           batch),
                                  jax.random.PRNGKey(s))
        p, tst, tm = my_step(p, tst, _torch_batch(batch), None)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5, s
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    _compare_after_adam(p, ref_p)
    _compare_trees(tst.mu, jst.mu, 1e-5)
    # the optimizer state carries across too
    back = model.opt_state_from_numpy(cfg, jax.tree.map(np.asarray, jst))
    assert int(back.step) == 3 and back.ef is None
    _compare_trees(back.nu, jst.nu, 0.0)
    np_state = model.opt_state_to_numpy(back)
    assert np_state.ef is None and int(np_state.step) == 3


def test_bf16_weight_gather_step_matches_reference():
    ref_cfg, cfg = _cfgs(bf16_weight_gather=True, dtype="bfloat16")
    ref_p, p = _params(ref_cfg, cfg)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefTrainConfig(**kw)))
    my_step = step.make_train_step(cfg, TrainConfig(**kw))
    jst, tst = ref_optim.init_opt_state(ref_p), optim.init_opt_state(p)
    batch = SyntheticLM(cfg, 4, S, seed=1).global_batch(0)
    _, _, jm = ref_step(ref_p, jst, jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(0))
    p, tst, tm = my_step(p, tst, _torch_batch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-2
    for t in leaves(p):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()


def test_int8_ef_train_step_matches_reference():
    ref_cfg, cfg = _cfgs()
    ref_p, p = _params(ref_cfg, cfg)
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=10,
              grad_compression="int8_ef")
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefTrainConfig(**kw)))
    my_step = step.make_train_step(cfg, TrainConfig(**kw))
    jst = ref_optim.init_opt_state(ref_p, with_ef=True)
    tst = optim.init_opt_state(p, with_ef=True)
    data = SyntheticLM(cfg, 4, S, seed=2)
    for s in range(2):
        batch = data.global_batch(s)
        ref_p, jst, jm = ref_step(ref_p, jst, jax.tree.map(jnp.asarray,
                                                           batch),
                                  jax.random.PRNGKey(s))
        p, tst, tm = my_step(p, tst, _torch_batch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        assert tst.ef is None and jst.ef is None     # dropped, both sides
    _compare_after_adam(p, ref_p)


@pytest.mark.parametrize("chunked", [False, True])
def test_eval_step_matches_reference(chunked):
    ref_cfg, cfg = _cfgs(chunked_ce=chunked, ce_chunks=4)
    ref_p, p = _params(ref_cfg, cfg)
    batch = _batch(cfg, seed=4)
    want = ref_make_eval_step(ref_cfg)(ref_p, jax.tree.map(jnp.asarray,
                                                           batch))
    got = step.make_eval_step(cfg)(p, _torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k
    assert not got["loss"].requires_grad
