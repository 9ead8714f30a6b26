"""The port's Mamba-2 SSD mixer against the reference's, on the CPU at
reduced mamba2-780m (d_model 128, 16 SSD heads of 16, N=16, conv 4): the
same numpy inputs and weights go through both packages.

Bars: every piece (the causal conv, the chunked scan with and without an
initial state, ``apply`` with its returned state, ``init_state`` and
several ``decode`` steps) within 1e-5 of max(1, the largest reference
value): the reference's ``jnp.cumsum`` (a reduce-window sum in XLA) adds
in another order than the port's sequential one, which moves outputs of
~30 by a few f32 steps. The masked
exponent of the intra-chunk decay is bitwise the reference's form in the
forward; at chunk 128 the reference's gradient is NaN where the port's is
finite, and at chunk 16 the two gradients agree within 1e-4 of max(1, the
largest reference value)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.mamba as ref_mamba
import repro_torch.configs as configs
from repro_torch.models import mamba

torch.set_num_threads(1)

B, L = 2, 32


def _cfgs(**over):
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config("mamba2-780m")), **over)
    mine = dataclasses.replace(configs.reduced(
        configs.get_config("mamba2-780m")), **over)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    return ref, mine


def _params(cfg, seed=0):
    """Numpy weights for one mixer: the reference's init scales for the
    matrices, and random values (not the init's constants) for the conv
    bias, A_log, D, dt_bias and the norm."""
    r = np.random.default_rng(seed)
    out = {}
    for name, d in sorted(mamba.param_defs(cfg).items()):
        scale = d.scale if d.scale is not None else 1 / np.sqrt(d.shape[0])
        out[name] = (r.standard_normal(d.shape) * scale).astype(np.float32)
    h = cfg.ssm_heads
    out["A_log"] = np.log(r.uniform(1, 16, h)).astype(np.float32)
    out["dt_bias"] = r.uniform(-4, -1, h).astype(np.float32)
    out["D"] = r.uniform(0.5, 1.5, h).astype(np.float32)
    out["norm"] = r.uniform(0.5, 1.5, cfg.d_inner).astype(np.float32)
    out["conv_b"] = (0.1 * r.standard_normal(out["conv_b"].shape)).astype(
        np.float32)
    return out


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


def _ssd_inputs(seed, H=4, P=8, N=16, n=L):
    r = np.random.default_rng(seed)
    xh = r.standard_normal((B, n, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, n, H)))).astype(np.float32)
    A = -np.exp(r.uniform(0, 1, H)).astype(np.float32)
    Bm = r.standard_normal((B, n, N)).astype(np.float32)
    Cm = r.standard_normal((B, n, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


def test_causal_conv():
    r = np.random.default_rng(1)
    x = r.standard_normal((B, L, 48)).astype(np.float32)
    w = r.standard_normal((4, 48)).astype(np.float32)
    b = r.standard_normal(48).astype(np.float32)
    _close(mamba._causal_conv(*map(torch.from_numpy, (x, w, b))),
           ref_mamba._causal_conv(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [8, 32, 64])          # < L, == L, > L
def test_ssd_chunked(chunk, with_state):
    ins = _ssd_inputs(2)
    s0 = (np.random.default_rng(3).standard_normal((B, 4, 8, 16)).astype(
        np.float32) if with_state else None)
    y, st = mamba.ssd_chunked(*map(torch.from_numpy, ins), chunk,
                              initial_state=(None if s0 is None
                                             else torch.from_numpy(s0)))
    ry, rst = ref_mamba.ssd_chunked(*map(jnp.asarray, ins), chunk,
                                    initial_state=(None if s0 is None
                                                   else jnp.asarray(s0)))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, ry)
    _close(st, rst)


def test_intra_chunk_decay_is_bitwise_the_reference_form():
    """exp(where(i >= j, d, -inf)) == where(i >= j, exp(d), 0) bit for bit,
    at chunk 128 where the upper triangle's exp overflows to inf."""
    _, dt, A, _, _ = _ssd_inputs(4, n=128)
    cumq = torch.cumsum(torch.from_numpy(dt * A), dim=1)     # (B, 128, H)
    got = mamba.intra_chunk_decay(cumq)
    diff = cumq[:, :, None, :] - cumq[:, None, :, :]
    ltri = torch.ones((128, 128), dtype=torch.bool).tril()[None, :, :, None]
    with np.errstate(over="ignore"):
        want = torch.where(ltri, torch.exp(diff), torch.zeros(()))
    assert torch.isinf(torch.exp(diff)).any()                # it does overflow
    assert torch.equal(got, want)
    assert got.view(torch.int32).equal(want.view(torch.int32))


def _grads_ref(ins, chunk):
    def f(*a):
        y, st = ref_mamba.ssd_chunked(*a, chunk)
        return y.sum() + 0.5 * st.sum()
    return jax.grad(f, argnums=tuple(range(5)))(*map(jnp.asarray, ins))


def _grads_port(ins, chunk):
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, st = mamba.ssd_chunked(*ts, chunk)
    (y.sum() + 0.5 * st.sum()).backward()
    return [t.grad for t in ts]


def test_ssd_gradient_is_finite_where_the_reference_is_nan():
    """B=2, L=128, H=4 at chunk 128: the reference's gradient with respect
    to dt is NaN everywhere (its upper-triangle exp overflows), the port's
    is finite; both forwards are finite and agree."""
    ins = _ssd_inputs(5, n=128)
    rg = _grads_ref(ins, 128)
    assert np.isnan(np.asarray(rg[1])).all()
    pg = _grads_port(ins, 128)
    for g in pg:
        assert bool(torch.isfinite(g).all())
    y, _ = mamba.ssd_chunked(*map(torch.from_numpy, ins), 128)
    ry, _ = ref_mamba.ssd_chunked(*map(jnp.asarray, ins), 128)
    assert np.isfinite(np.asarray(ry)).all()
    _close(y, ry)


def test_ssd_gradients_match_the_reference_at_chunk_16():
    ins = _ssd_inputs(6, n=64)
    for g, rg in zip(_grads_port(ins, 16), _grads_ref(ins, 16)):
        assert np.isfinite(np.asarray(rg)).all()
        _close(g, rg, 1e-4)


def test_apply_with_state():
    ref_cfg, cfg = _cfgs()
    rp, p = _both(_params(cfg))
    x = np.random.default_rng(7).standard_normal(
        (B, L, cfg.d_model)).astype(np.float32)
    out, st = mamba.apply(p, cfg, torch.from_numpy(x), return_state=True)
    rout, rst = ref_mamba.apply(rp, ref_cfg, jnp.asarray(x),
                                return_state=True)
    _close(out, rout)
    assert set(st) == set(rst) == {"ssm", "conv"}
    for n in st:
        assert st[n].dtype == torch.float32
        _close(st[n], rst[n])
    _close(mamba.apply(p, cfg, torch.from_numpy(x)), rout)


def test_init_state():
    ref_cfg, cfg = _cfgs()
    got, want = mamba.init_state(cfg, 3), ref_mamba.init_state(ref_cfg, 3)
    assert set(got) == set(want)
    for n in got:
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_decode_steps():
    """A prompt's state from ``apply``, then five one-token steps."""
    ref_cfg, cfg = _cfgs()
    rp, p = _both(_params(cfg, seed=8))
    x = np.random.default_rng(9).standard_normal(
        (B, L + 5, cfg.d_model)).astype(np.float32)
    _, st = mamba.apply(p, cfg, torch.from_numpy(x[:, :L]),
                        return_state=True)
    _, rst = ref_mamba.apply(rp, ref_cfg, jnp.asarray(x[:, :L]),
                             return_state=True)
    for i in range(L, L + 5):
        before = {n: t.clone() for n, t in st.items()}
        out, st_new = mamba.decode(p, cfg, torch.from_numpy(x[:, i:i + 1]),
                                   st)
        rout, rst = ref_mamba.decode(rp, ref_cfg, jnp.asarray(x[:, i:i + 1]),
                                     rst)
        assert all(torch.equal(before[n], st[n]) for n in st)   # not written
        st = st_new
        _close(out, rout)
        for n in st:
            _close(st[n], rst[n])


def test_decode_continues_the_full_sequence():
    """The port's own consistency: apply over L+1 tokens in one chunk ==
    apply over L in chunks of 16, then one decode step."""
    _, cfg = _cfgs()
    _, p = _both(_params(cfg, seed=10))
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, L + 1, cfg.d_model)).astype(np.float32))
    prompt, st = mamba.apply(p, cfg, x[:, :L], return_state=True)
    out, _ = mamba.decode(p, cfg, x[:, L:], st)
    cfg2 = dataclasses.replace(cfg, ssm_chunk=L + 1)
    whole = mamba.apply(p, cfg2, x)
    _close(out[:, 0], whole[:, L].detach())
    _close(prompt, whole[:, :L].detach())
