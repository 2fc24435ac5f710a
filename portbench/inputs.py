"""The benchmark's inputs, made from `--seed`: weather fields, weights and
the seeds of the dropout generators. Both sides of the comparison read
these and nothing else.

The field generator is a frozen copy of the port's
`data/synthetic.py` (diurnal and annual cycles plus travelling waves,
noise keyed on the box), so that a later change to the program cannot
change what the benchmark feeds it. ERA5 is not in the repository: the
fields are synthetic (`assumed` in each configuration file). Speed depends
on their shapes, which are the reference's, not on their values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUM_VARS = 12
HOURS_PER_YEAR = 8766  # the spread of each box's start hour
_VAR_OFFSET = np.array(
    [0.0, 0.0, 288.0, 283.0, 1.013e5, 1e-4, 0.0, 0.0, -3e5, 0.5, 0.4, -3e-4],
    dtype=np.float64,
)
_VAR_SCALE = np.array(
    [5.0, 5.0, 8.0, 7.0, 800.0, 3e-4, 8.0, 8.0, 8e4, 0.3, 0.3, 2e-4],
    dtype=np.float64,
)


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's seed and integer tags."""
    state = np.random.SeedSequence([int(seed), *[int(t) for t in tags]]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31 | int(state[1])) & ((1 << 63) - 1)


class Field:
    """One box's raw fields: weather [T, lat, lon, 12] float32, times [T]
    datetime64, lats, lons, and its Koppen class code."""

    def __init__(self, weather, times, lats, lons, koppen_code: int):
        self.weather, self.times = weather, times
        self.lats, self.lons, self.koppen_code = lats, lons, koppen_code


def box_field(box, *, timesteps: int, resolution: float, seed: int, hour_offset: int,
              koppen_code: int, noise: float = 0.05) -> Field:
    """Fields of one lat/lon box on a regular grid, hourly from
    2020-01-01 + `hour_offset` hours. Wave parameters depend on (seed,
    variable) only, so boxes of one seed sample one global field."""
    lat_min, lat_max, lon_min, lon_max = (float(v) for v in box)
    lats = np.arange(lat_min, lat_max + 1e-9, resolution)
    lons = np.arange(lon_min, lon_max + 1e-9, resolution)
    hours = hour_offset + np.arange(timesteps)
    times = np.datetime64("2020-01-01T00:00") + hours * np.timedelta64(1, "h")
    diurnal = np.sin(2 * np.pi * hours / 24.0)[:, None, None]
    annual = np.sin(2 * np.pi * hours / (24.0 * 365.25))[:, None, None]
    lat_g, lon_g = np.meshgrid(lats, lons, indexing="ij")
    weather = np.empty((timesteps, len(lats), len(lons), NUM_VARS), dtype=np.float32)
    box_key = (int(round((lat_min + 90.0) * 100)), int(round((lon_min + 360.0) * 100)))
    for v in range(NUM_VARS):
        prng = np.random.default_rng((seed, v))
        phase = prng.uniform(0, 2 * np.pi)
        kx, ky = prng.uniform(0.5, 2.0, size=2)
        speed = prng.uniform(0.05, 0.2)
        wave = np.sin(kx * lat_g[None] + ky * lon_g[None] + speed * hours[:, None, None]
                      + phase)
        base = 0.45 * diurnal + 0.25 * annual + 0.5 * wave
        nrng = np.random.default_rng((seed, v, *box_key, hour_offset))
        base = base + noise * nrng.standard_normal(base.shape)
        weather[..., v] = (_VAR_OFFSET[v] + _VAR_SCALE[v] * base).astype(np.float32)
    return Field(weather, times, lats.astype(np.float64), lons.astype(np.float64),
                 koppen_code)


def fields(boxes, data: dict, seed: int) -> list[Field]:
    """Every box's fields for one run: the global wave field, each box's
    start hour and Koppen code (1-30) all drawn from `seed`."""
    rng = np.random.default_rng(subseed(seed, 1))
    offsets = rng.integers(0, HOURS_PER_YEAR, size=len(boxes))
    codes = rng.integers(1, 31, size=len(boxes))
    wave_seed = subseed(seed, 2)
    return [
        box_field(box, timesteps=data["timesteps"], resolution=data["resolution"],
                  seed=wave_seed, hour_offset=int(off), koppen_code=int(code))
        for box, off, code in zip(boxes, offsets, codes)
    ]


def leaf_specs(model: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, bound) of every parameter, in the port's
    `named_parameters()` names: GCN weights Glorot-uniform and biases zero,
    LSTM and head uniform(1/sqrt(fan)), the Koppen table normal, as the
    reference initialises them."""
    hid, layers = model["hidden_channels"], model["gcn_layers"]
    specs, d_in = [], model["num_weather_vars"] + model["num_time_vars"] + model["koppen_dim"]
    for l in range(layers):
        specs.append((f"encoder.layers.{l}.w", (d_in, hid), "uniform",
                      math.sqrt(6.0 / (d_in + hid))))
        specs.append((f"encoder.layers.{l}.b", (hid,), "zeros", 0.0))
        d_in = hid
    out = model["num_weather_vars"] * model["horizon"]
    if model["family"] == "hybrid":
        h = model["lstm_hidden"]
        bound = 1.0 / math.sqrt(h)
        for l in range(model["lstm_layers"]):
            specs.append((f"lstm.layers.{l}.wx", (hid if l == 0 else h, 4 * h), "uniform",
                          bound))
            specs.append((f"lstm.layers.{l}.wh", (h, 4 * h), "uniform", bound))
            specs.append((f"lstm.layers.{l}.b", (4 * h,), "uniform", bound))
        head_in = h
    else:
        head_in = hid
    specs.append(("head.w", (head_in, out), "uniform", 1.0 / math.sqrt(head_in)))
    specs.append(("head.b", (out,), "uniform", 1.0 / math.sqrt(head_in)))
    specs.append(("koppen", (model["koppen_classes"], model["koppen_dim"]), "normal", 1.0))
    return specs


def weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The run's float32 weights {name: tensor}, made on `device` from the
    seed in two calls (one uniform, one normal draw) and cut into leaves."""
    specs = leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, 3))
    n_uniform = sum(math.prod(s) for _, s, init, _ in specs if init == "uniform")
    n_normal = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, iu, ino = {}, 0, 0
    for name, shape, init, bound in specs:
        n = math.prod(shape)
        if init == "uniform":
            out[name] = (uniform[iu:iu + n] * bound).reshape(shape)
            iu += n
        elif init == "normal":
            out[name] = normal[ino:ino + n].reshape(shape).clone()
            ino += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def dropout_seed(seed: int, step: int) -> int:
    """The seed of meta step `step`'s dropout generator (a torch.Generator
    on the device, consumed by the program in its documented order)."""
    return subseed(seed, 4, step)


def sampler_seed(seed: int) -> int:
    """The seed of the task sampler's numpy generator."""
    return subseed(seed, 5)
