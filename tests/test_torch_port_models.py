"""The PyTorch port's host code and models against the JAX package, on the CPU.

Config defaults, synthetic data, features, graph and window gathering must
equal the JAX package's; the eval forwards (hybrid and stgcn families,
`make_predict` over a window batch) must match within float32 1e-4 for the
whole model and bfloat16 5e-2. JAX parameters reach the port through
utils/convert.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from weatherforecast_stgcn_maml_tpu import config as jcfg
from tests._host_route import restore_host_routes, use_same_host_route
from weatherforecast_stgcn_maml_tpu.data.preprocess import prepare_features as jax_features
from weatherforecast_stgcn_maml_tpu.data.synthetic import synthetic_region as jax_region
from weatherforecast_stgcn_maml_tpu.data.windows import WindowSpec as JaxWindowSpec
from weatherforecast_stgcn_maml_tpu.data.windows import gather_batch as jax_gather
from weatherforecast_stgcn_maml_tpu.graph import build_region_graph as jax_graph
from weatherforecast_stgcn_maml_tpu.models.common import lstm_bias as jax_lstm_bias
from weatherforecast_stgcn_maml_tpu.models.registry import init_model as jax_init_model
from weatherforecast_stgcn_maml_tpu.train.supervised import make_predict as jax_make_predict
from weatherforecast_stgcn_maml_tpu_torch import config as tcfg
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import pad_nodes, prepare_features
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec, gather_batch
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.hybrid import apply_hybrid
from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model, init_model
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import make_predict
from weatherforecast_stgcn_maml_tpu_torch.utils.convert import (
    params_from_state_dict,
    state_dict_from_params,
)

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

SMALL = dict(hidden_channels=16, gcn_layers=2, lstm_hidden=8, lstm_layers=2, window=6,
             horizon=3, koppen_dim=4)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture()
def same_host_route():
    """Both packages on one host route (`tests/_host_route.py`)."""
    use_same_host_route()
    yield
    restore_host_routes()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "CompatConfig", "ExperimentConfig"])
def test_config_defaults_equal_jax(name):
    port, ref = getattr(tcfg, name)(), getattr(jcfg, name)()
    fields = [f.name for f in dataclasses.fields(port)]
    assert fields, name
    for field in fields:
        got, want = getattr(port, field), getattr(ref, field)
        if dataclasses.is_dataclass(got):
            assert tcfg.to_dict(got) == jcfg.to_dict(want), field
        else:
            assert got == want, field
    if name == "ModelConfig":
        assert {f.name for f in dataclasses.fields(ref)} == set(fields)
        assert (port.in_channels, port.feature_channels) == (ref.in_channels, ref.feature_channels)


def test_config_constants_and_overrides_equal_jax():
    for const in ("WEATHER_VARS", "TIME_VARS", "T2M_INDEX", "ADAPTATION_REGIONS"):
        assert getattr(tcfg, const) == getattr(jcfg, const), const
    overrides = ["model.compute_dtype=bfloat16", "data.train_years=2021,2022",
                 "compat.koppen_zero_in_adapt=yes", "out_dir=o2", "model.window=12"]
    port = tcfg.apply_overrides(tcfg.ExperimentConfig(), overrides)
    ref = jcfg.apply_overrides(jcfg.ExperimentConfig(), overrides)
    for section in ("model", "data", "compat"):
        assert tcfg.to_dict(getattr(port, section)) == jcfg.to_dict(getattr(ref, section))
    # A config dict written by the JAX package (with its training sections) loads.
    loaded = tcfg.experiment_from_dict(jcfg.to_dict(ref))
    assert loaded == port
    with pytest.raises(ValueError):
        tcfg.apply_overrides(tcfg.ExperimentConfig(), ["compat.koppen_zero_in_adapt=Ture"])


def test_host_pipeline_equals_jax(same_host_route):
    kw = dict(num_timesteps=40, seed=3, nan_fraction=0.05, hour_offset=7)
    region = synthetic_region(10.0, 11.0, 20.0, 21.5, **kw)
    ref_region = jax_region(10.0, 11.0, 20.0, 21.5, **kw)
    np.testing.assert_array_equal(region.weather, ref_region.weather)
    np.testing.assert_array_equal(region.times, ref_region.times)

    feats, stats = prepare_features(region, rel_coords=True)
    ref_feats, ref_stats = jax_features(ref_region, rel_coords=True)
    np.testing.assert_array_equal(feats, ref_feats)
    np.testing.assert_array_equal(stats.mean, ref_stats.mean)
    np.testing.assert_array_equal(stats.std, ref_stats.std)

    graph = build_region_graph(region.lats, region.lons, k_neighbors=4)
    ref_graph = jax_graph(region.lats, region.lons, k_neighbors=4)
    np.testing.assert_array_equal(graph.a_hat, ref_graph.a_hat)
    np.testing.assert_array_equal(graph.node_mask, ref_graph.node_mask)
    assert graph.padded_nodes == 128 and graph.num_nodes == 35

    padded = pad_nodes(feats, graph.padded_nodes)
    spec, anchors = WindowSpec(6, 3), np.array([6, 11, 30])
    x, y = gather_batch(torch.from_numpy(padded), torch.from_numpy(anchors), spec)
    rx, ry = jax_gather(jnp.asarray(padded), jnp.asarray(anchors), JaxWindowSpec(6, 3))
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    with pytest.raises(ValueError, match="anchors"):
        gather_batch(torch.from_numpy(padded), torch.tensor([37]), spec)


def _models(family, seed=0):
    jax_mc = jcfg.ModelConfig(family=family, **SMALL)
    jparams = _np(jax_init_model(jax.random.key(seed), jax_mc))
    model = init_model(torch.Generator().manual_seed(seed), tcfg.ModelConfig(family=family, **SMALL))
    model.load_state_dict(state_dict_from_params(jparams))
    return jparams, model.requires_grad_(False)


def _batch():
    lats = np.arange(10.0, 11.0 + 1e-9, 0.25)
    lons = np.arange(20.0, 21.0 + 1e-9, 0.25)
    a_hat = jax_graph(lats, lons).a_hat
    x = np.random.default_rng(7).normal(size=(3, 6, 128, 16)).astype(np.float32)
    return a_hat, x


@pytest.mark.parametrize("family", ["hybrid", "stgcn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_predict_matches_jax(family, dtype):
    jparams, model = _models(family)
    a_hat, x = _batch()
    ref = jax_make_predict(jcfg.ModelConfig(family=family, compute_dtype=dtype, **SMALL))(
        jparams, jnp.asarray(x), jnp.asarray(a_hat), jnp.int32(5)
    )
    predict = make_predict(tcfg.ModelConfig(family=family, compute_dtype=dtype, **SMALL))
    got = predict(model, torch.from_numpy(x), torch.from_numpy(a_hat), 5)
    assert got.shape == (3, 3, 128, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL[dtype])


@pytest.mark.parametrize(
    "route", [dict(use_pallas_gcn=False), dict(lstm_kernel="xla"), dict(lstm_kernel="pallas_stack")]
)
def test_apply_hybrid_routes_match_jax(route):
    """One window, unbatched, on each route the config selects."""
    jparams, model = _models("hybrid", seed=1)
    a_hat, x = _batch()
    ref = jax_make_predict(jcfg.ModelConfig(**SMALL))(
        jparams, jnp.asarray(x[:1]), jnp.asarray(a_hat), jnp.int32(0)
    )[0]
    with torch.no_grad():
        got = apply_hybrid(
            model, torch.from_numpy(a_hat), torch.from_numpy(x[0]), 0,
            tcfg.ModelConfig(**SMALL, **route),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL["float32"])


@pytest.mark.parametrize("route", [dict(lstm_wavefront=True)])
def test_predict_on_the_wavefront_matches_jax(route):
    """`make_predict` over a batch of 3 windows with `model.lstm_wavefront`
    (the serving forward of `forecast` and `validate`) against JAX's, float32."""
    jparams, model = _models("hybrid", seed=1)
    a_hat, x = _batch()
    ref = jax_make_predict(jcfg.ModelConfig(**SMALL, **route))(
        jparams, jnp.asarray(x), jnp.asarray(a_hat), jnp.int32(4))
    got = make_predict(tcfg.ModelConfig(**SMALL, **route))(
        model, torch.from_numpy(x), torch.from_numpy(a_hat), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL["float32"])


def test_convert_round_trip_with_split_lstm_bias():
    jparams, _ = _models("hybrid", seed=2)
    back = params_from_state_dict(state_dict_from_params(jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)

    rng = np.random.default_rng(0)
    split = jax.tree.map(lambda a: a, jparams)
    for layer in split["lstm"]["layers"]:
        b = layer.pop("b")
        layer["b_ih"] = rng.normal(size=b.shape).astype(np.float32)
        layer["b_hh"] = (b - layer["b_ih"]).astype(np.float32)
    state_dict = state_dict_from_params(split)
    assert "lstm.layers.0.b_ih" not in state_dict
    fused = params_from_state_dict(state_dict)
    for got, layer in zip(fused["lstm"]["layers"], split["lstm"]["layers"]):
        np.testing.assert_array_equal(got["b"], np.asarray(jax_lstm_bias(layer)))
    model = init_model(torch.Generator().manual_seed(0), tcfg.ModelConfig(**SMALL))
    model.load_state_dict(state_dict)  # strict: every key present, no extra
