"""The microbatched train step's metrics on an MoE model, pinned (ROADMAP
Queue 3): with ``num_microbatches > 1`` the reference's step reports
``{"ce": loss, "moe_aux": 0}`` (``src/repro/train/step.py:67``), where
``loss`` is the mean of each microbatch's total loss, ``ce + router_aux_coef
* aux``; the port copies this (``repro_torch/train/step.py``) for parity.
So a microbatched MoE run reports its total loss as ``ce`` and its aux as
0. The loss and the gradients are right; the reference is the wrong side,
and this test pins the copy, it does not change it.

A reduced qwen2-moe-a2.7b in f32 with two microbatches: the port's metrics
equal the reference's; its ``ce`` exceeds the microbatches' own ``ce``
(each microbatch run as a single batch) by exactly the aux term, and its
``moe_aux`` is 0, where the single-batch step reports a positive aux.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
import repro.models.model as ref_model
from repro.config import TrainConfig as RefTrainConfig
from repro.train import optim as ref_optim
from repro.train.step import make_train_step as ref_make_train_step
import repro_torch.configs as configs
from repro_torch.config import TrainConfig
from repro_torch.models import model
from repro_torch.train import optim, step
from repro_torch.train.data import SyntheticLM
from repro_torch.train.tree import map_tree

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
B, S = 4, 16
M = 2                       # microbatches


def _setup():
    over = dict(remat_policy="none", dtype="float32")
    ref_cfg = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(ARCH)), **over)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(ARCH)),
                              **over)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    ref_p = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    p = model.params_from_numpy(cfg, jax.tree.map(np.asarray, ref_p))
    batch = SyntheticLM(cfg, B, S, seed=0).global_batch(0)
    return ref_cfg, cfg, ref_p, p, batch


def _port_step(cfg, p, batch, m):
    train_step = step.make_train_step(
        cfg, TrainConfig(num_microbatches=m, warmup_steps=1, total_steps=4))
    p = map_tree(torch.clone, p)
    _, _, metrics = train_step(p, optim.init_opt_state(p),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


def test_microbatched_moe_metrics_pin_the_reference():
    ref_cfg, cfg, ref_p, p, batch = _setup()
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefTrainConfig(
        num_microbatches=M, warmup_steps=1, total_steps=4)))
    _, _, jm = ref_step(ref_p, ref_optim.init_opt_state(ref_p),
                        jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(0))
    got = _port_step(cfg, p, batch, M)
    # the port's metrics are the reference's, mislabelling included
    assert got["moe_aux"] == float(jm["moe_aux"]) == 0.0
    assert abs(got["ce"] - float(jm["ce"])) <= 1e-5
    assert got["ce"] == got["loss"]

    # each microbatch as a single batch: its own ce and aux
    mbs = step._microbatch({k: torch.from_numpy(v)
                            for k, v in batch.items()}, M)
    ces, auxes = [], []
    with torch.no_grad():
        for i in range(M):
            _, m = model.loss_fn(p, cfg, {k: v[i] for k, v in mbs.items()})
            ces.append(float(m["ce"]))
            auxes.append(float(m["moe_aux"]))
    aux_term = cfg.router_aux_coef * float(np.mean(auxes))
    assert aux_term > 0
    assert got["ce"] > float(np.mean(ces))
    np.testing.assert_allclose(got["ce"] - float(np.mean(ces)), aux_term,
                               rtol=1e-4)

    # the single-batch step labels its terms apart
    single = _port_step(cfg, p, batch, 1)
    assert single["moe_aux"] > 0
    np.testing.assert_allclose(
        single["loss"], single["ce"] + cfg.router_aux_coef
        * single["moe_aux"], rtol=1e-6)
