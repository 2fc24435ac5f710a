"""The plain reference against the port's plain routes on the CPU, at a
small size: the host pipeline, the dropout masks, both families' forward
passes and one first-order meta step."""

import copy

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import meta as rmeta, models, pipeline
from weatherforecast_stgcn_maml_tpu_torch.config import DataConfig, MetaConfig, ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import prepare_features
from weatherforecast_stgcn_maml_tpu_torch.data.region import RegionData
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, draw_masks, init_model
from weatherforecast_stgcn_maml_tpu_torch.train.maml import init_meta_state, make_meta_step
from weatherforecast_stgcn_maml_tpu_torch.train.tasks import Task, build_task, stack_tasks

torch.set_num_threads(1)
DATA = {"resolution": 1.0, "timesteps": 60, "k_neighbors": 4}
BOXES = [[18, 23, 75, 80], [8, 13, 98, 103], [53, 58, 35, 40], [-20, -15, -70, -65]]


def model_dict(family: str, dtype: str = "float64") -> dict:
    import dataclasses
    return dataclasses.asdict(ModelConfig(
        family=family, hidden_channels=16, gcn_layers=3, lstm_hidden=8, lstm_layers=2,
        window=8, horizon=4, compute_dtype=dtype))


def region(f, i=0):
    return RegionData(weather=f.weather, times=f.times, lats=f.lats, lons=f.lons,
                      koppen_code=f.koppen_code, name=f"box{i}")


def port_model(model: dict, seed: int):
    m = init_model(torch.Generator().manual_seed(0), ModelConfig(**model)).double()
    w = inputs.weights(model, seed, "cpu")
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(w[k])
    return m, {k: v.double() for k, v in w.items()}


def test_pipeline_against_the_port():
    f = inputs.fields(BOXES[:1], DATA, 11)[0]
    n = f.lats.size * f.lons.size
    graph = build_region_graph(f.lats, f.lons, k_neighbors=4)
    np.testing.assert_allclose(pipeline.adjacency(f.lats, f.lons, 4), graph.a_hat[:n, :n],
                               rtol=1e-6, atol=1e-7)
    assert graph.padded_nodes == pipeline.padded_nodes(n)
    feats, _ = prepare_features(region(f))
    np.testing.assert_allclose(pipeline.features(f), feats, rtol=0, atol=2e-5)
    meta = {"max_samples_per_task": 600, "support_fraction": 0.75, "inner_batches": 15,
            "query_batches": 1}
    model = model_dict("hybrid")
    task = build_task(region(f), ModelConfig(**model), MetaConfig(inner_batches=15),
                      DataConfig(k_neighbors=4)).task
    s_anchors, q_anchors = pipeline.task_anchors(60, 8, 4, meta)
    sx, sy = pipeline.windows(pipeline.features(f), s_anchors, 8, 4)
    qx, _ = pipeline.windows(pipeline.features(f), q_anchors, 8, 4)
    np.testing.assert_allclose(sx, task.support_x[:, :, :n].numpy(), atol=2e-5)
    np.testing.assert_allclose(sy, task.support_y[:, :, :n].numpy(), atol=2e-5)
    np.testing.assert_allclose(qx, task.query_x[:, :, :n].numpy(), atol=2e-5)


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_masks_are_the_ports_draws(family):
    model = model_dict(family, "float32")
    x = torch.zeros(8, 128, 16)
    port = draw_masks(ModelConfig(**model), torch.Generator().manual_seed(5), x)
    ref = models.draw_masks(model, torch.Generator().manual_seed(5), 128, "cpu")
    assert set(port) == set(ref)
    for k in port:
        assert torch.equal(port[k].bool(), ref[k])


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_against_the_port(family, train):
    model = model_dict(family)
    f = inputs.fields(BOXES[:1], DATA, 12)[0]
    n = f.lats.size * f.lons.size
    a_hat = torch.from_numpy(pipeline.adjacency(f.lats, f.lons, 4)).double()
    x = torch.from_numpy(pipeline.features(f)[:8]).double()
    m, w = port_model(model, 13)
    masks = models.draw_masks(model, torch.Generator().manual_seed(9) if train else None,
                              n, "cpu")
    with torch.no_grad():
        port = apply_model(m, a_hat, x, 7, ModelConfig(**model), train=train,
                           masks={k: v.to(torch.int8) for k, v in masks.items()})
    ref = models.forward(model, w, a_hat, x, 7, masks)
    torch.testing.assert_close(port, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
def test_meta_step_against_the_port(family):
    """One first-order meta step of 4 tasks (grad-accum 2) from the same
    task tensors, weights and dropout seed, float64."""
    model = model_dict(family)
    meta_cfg = MetaConfig(inner_epochs=2, inner_batches=3)
    meta = {k: getattr(meta_cfg, k) for k in (
        "meta_batch", "grad_accum", "inner_epochs", "inner_lr", "outer_lr", "weight_decay",
        "clip_norm", "cosine_t0", "cosine_t_mult", "eta_min", "query_train_mode",
        "query_batches")}
    fields = inputs.fields(BOXES, DATA, 14)
    built = [build_task(region(f, i), ModelConfig(**model), meta_cfg,
                        DataConfig(k_neighbors=4), pad_to=128).task for i, f in enumerate(fields)]
    n = fields[0].lats.size * fields[0].lons.size
    tasks = Task(*(t.double() if t.is_floating_point() else t for t in stack_tasks(built)))
    state = init_meta_state(torch.Generator().manual_seed(0), ModelConfig(**model), meta_cfg)
    _, w = port_model(model, 15)
    with torch.no_grad():
        for k, p in state.params.named_parameters():
            p.copy_(w[k])
    idx = [2, 0, 3, 1]
    step = make_meta_step(ModelConfig(**model), meta_cfg)
    state, metrics = step(state, Task(*(t[idx] for t in tasks)),
                          torch.Generator().manual_seed(21))
    rtasks = [rmeta.Task(t.support_x[:, :, :n], t.support_y[:, :, :n], t.query_x[:, :, :n],
                         t.query_y[:, :, :n], t.a_hat[:n, :n], int(t.koppen), 128)
              for t in (Task(*(f[i] for f in tasks)) for i in range(4))]
    rstate, losses = rmeta.meta_step(model, meta, rmeta.init_state(w), rtasks, idx,
                                     torch.Generator().manual_seed(21))
    np.testing.assert_allclose(metrics["per_task_loss"].numpy(), losses, rtol=1e-10)
    for k, p in state.params.named_parameters():
        torch.testing.assert_close(p.detach(), rstate.params[k], rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(state.opt_state.mu[k], rstate.mu[k], rtol=1e-8, atol=1e-14)


def test_sampler_and_schedule_against_the_port():
    from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import MetaOptimizer
    from weatherforecast_stgcn_maml_tpu_torch.train.sampling import DifficultySampler

    port, ref = DifficultySampler(15, 4, 0.9, 99), rmeta.Sampler(15, 4, 0.9, 99)
    rng = np.random.default_rng(0)
    for _ in range(6):
        i, j = port.sample(), ref.sample()
        np.testing.assert_array_equal(i, j)
        losses = rng.random(4)
        port.update(i, losses)
        ref.update(j, losses)
    meta = copy.deepcopy(MetaConfig())
    sched = MetaOptimizer(meta).schedule
    cfg = {k: getattr(meta, k) for k in ("grad_accum", "cosine_t0", "cosine_t_mult",
                                         "eta_min", "outer_lr")}
    for count in (0, 1, 7, 19, 20, 21, 59, 60, 200):
        assert rmeta.schedule(cfg, count) == sched(count)
