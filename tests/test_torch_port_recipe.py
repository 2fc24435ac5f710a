"""The port's regional adaptation loop against a fresh torch implementation
of the reference's adaptation loop (adapt_hybrid_v5.py:164-231,
adaptive_scheduler.py:7-95), step by step, in float64.

The torch arm is the reference's executed loop: the reference hybrid
(`_RefHybrid`: GCN convs, `torch.nn.LSTM`, a linear head) trained window by
window with `torch.optim.Adam` (L2 weight decay in the gradient, the cold
zone's lr and decay) after `clip_grad_norm_`. The port arm starts from the
same weights, brought into the port's parameter tree by hand (`w` stored
[in, out], the LSTM's two biases kept as two parameters, as the reference
trains them), and takes the same windows through
`train/supervised.make_train_step` with the climate-aware Adam
(`adaptation_optimizer`, the Koppen table frozen as in the reference, whose
optimizer leaves the embedding out). Both must produce the same per-step
loss sequence to float64 accuracy (rtol 1e-7), on every LSTM route the port
has (the plain stack, the fused stack, the per-layer recurrence and the
eval stack of `model.use_pallas_lstm`, all plain on the CPU).

The reference arm mirrors the JAX package's tests/test_recipe_parity.py.
"""

import numpy as np
import pytest
import torch

from weatherforecast_stgcn_maml_tpu_torch.config import ModelConfig
from weatherforecast_stgcn_maml_tpu_torch.data.preprocess import prepare_features
from weatherforecast_stgcn_maml_tpu_torch.data.synthetic import synthetic_region_for_box
from weatherforecast_stgcn_maml_tpu_torch.data.windows import WindowSpec
from weatherforecast_stgcn_maml_tpu_torch.graph import build_region_graph
from weatherforecast_stgcn_maml_tpu_torch.models.registry import init_model, load_params
from weatherforecast_stgcn_maml_tpu_torch.train.optimizers import (
    adaptation_optimizer,
    masked_freeze,
    trainable_mask,
)
from weatherforecast_stgcn_maml_tpu_torch.train.supervised import SupervisedState, make_train_step

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

KOPPEN_DIM = 4
HIDDEN, GCN_LAYERS = 16, 2
LSTM_HIDDEN, LSTM_LAYERS = 8, 2
WINDOW, HORIZON = 6, 2
N_STEPS = 24
REGION = "Moscow"  # cold zone: lr x1.1, wd 5e-5


class _RefConv(torch.nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.lin = torch.nn.Linear(d_in, d_out, bias=False)
        self.bias = torch.nn.Parameter(torch.randn(d_out) * 0.1)

    def forward(self, a, x):
        return a @ self.lin(x) + self.bias


class _RefHybrid(torch.nn.Module):
    """Reference HybridSTGCN_LSTM semantics (hybrid_model.py:60-117)."""

    def __init__(self, n):
        super().__init__()
        in_ch = 16 + KOPPEN_DIM
        self.convs = torch.nn.ModuleList([
            _RefConv(in_ch if i == 0 else HIDDEN, HIDDEN)
            for i in range(GCN_LAYERS)
        ])
        self.lstm = torch.nn.LSTM(
            HIDDEN, LSTM_HIDDEN, num_layers=LSTM_LAYERS, batch_first=True
        )
        self.head = torch.nn.Linear(LSTM_HIDDEN, 12 * HORIZON)
        self.n = n

    def forward(self, a, x):  # [W, N, C]
        h = x
        for conv in self.convs:
            h = torch.relu(conv(a, h))
        h = h.permute(1, 0, 2)
        out, _ = self.lstm(h)
        return self.head(out[:, -1, :]).view(self.n, HORIZON, 12)


def _port_state(model: _RefHybrid, emb: torch.Tensor, split: bool) -> dict:
    """The reference's weights as the port's parameter tree, the LSTM's two
    biases kept apart (`split`) or fused."""
    sd = {}
    for i, conv in enumerate(model.convs):
        sd[f"encoder.layers.{i}.w"] = conv.lin.weight.detach().t()
        sd[f"encoder.layers.{i}.b"] = conv.bias.detach()
    for l in range(LSTM_LAYERS):
        pre = f"lstm.layers.{l}."
        sd[pre + "wx"] = getattr(model.lstm, f"weight_ih_l{l}").detach().t()
        sd[pre + "wh"] = getattr(model.lstm, f"weight_hh_l{l}").detach().t()
        b_ih = getattr(model.lstm, f"bias_ih_l{l}").detach()
        b_hh = getattr(model.lstm, f"bias_hh_l{l}").detach()
        if split:
            sd[pre + "b_ih"], sd[pre + "b_hh"] = b_ih, b_hh
        else:
            sd[pre + "b"] = b_ih + b_hh
    sd["head.w"] = model.head.weight.detach().t()
    sd["head.b"] = model.head.bias.detach()
    sd["koppen"] = emb.detach()
    return {k: v.clone().contiguous() for k, v in sd.items()}


@pytest.mark.parametrize("route", [
    dict(lstm_kernel="xla"), dict(lstm_kernel="auto"), dict(lstm_kernel="pallas"),
    dict(use_pallas_lstm=True),
])
@pytest.mark.parametrize("biases", ["split", "fused"])
def test_adaptation_loop_matches_reference_torch_loop_float64(route, biases):
    """`split`: the reference's two LSTM biases, both trained, against the
    port's layers loaded with both (`load_params`). `fused`: the
    reference's b_hh frozen at zero, so it trains one bias a layer, against
    the port's fused bias."""
    torch.manual_seed(0)
    model_cfg = ModelConfig(
        hidden_channels=HIDDEN, gcn_layers=GCN_LAYERS,
        lstm_hidden=LSTM_HIDDEN, lstm_layers=LSTM_LAYERS,
        window=WINDOW, horizon=HORIZON, koppen_dim=KOPPEN_DIM,
        gcn_dropout=0.0, lstm_dropout=0.0, compute_dtype="float64",
        # Reference recipe: the Koppen embedding is NOT in the adaptation
        # optimizer (quirk 11, adapt_hybrid_v5.py:172) -- the torch arm
        # bakes it into the features.
        train_koppen_embedding=False, **route,
    )
    region = synthetic_region_for_box(
        (10.0, 10.75, 20.0, 20.75), num_timesteps=40, seed=5, name=REGION
    )
    feats16, _ = prepare_features(region)
    graph = build_region_graph(region.lats, region.lons)
    n = feats16.shape[1]
    spec = WindowSpec(WINDOW, HORIZON)
    anchors = (spec.window + np.arange(spec.num_samples(region.num_timesteps)))[:N_STEPS]
    kcode = max(0, int(region.koppen_code))

    model = _RefHybrid(n).double()
    if biases == "fused":
        for l in range(LSTM_LAYERS):
            getattr(model.lstm, f"bias_hh_l{l}").detach().zero_()
            getattr(model.lstm, f"bias_hh_l{l}").requires_grad_(False)
    emb_t = torch.nn.Embedding(31, KOPPEN_DIM).double()
    # Taken before the torch arm trains its tensors in place.
    port_sd = _port_state(model, emb_t.weight, biases == "split")

    # ---- torch arm: the reference's executed loop ------------------------
    emb = emb_t.weight.detach().numpy()[kcode]
    x24 = np.concatenate(
        [feats16, np.broadcast_to(emb, (*feats16.shape[:2], KOPPEN_DIM))], axis=-1,
    ).astype(np.float64)
    a_t = torch.from_numpy(np.asarray(graph.a_hat)[:n, :n].astype(np.float64))
    feats_t = torch.from_numpy(feats16.astype(np.float64))
    xs_t = torch.from_numpy(x24)
    lr0 = 6e-4 * 1.1
    opt = torch.optim.Adam(model.parameters(), lr=lr0, weight_decay=5e-5)
    crit = torch.nn.MSELoss()
    model.train()
    torch_losses = []
    for t in anchors:
        t = int(t)
        xw = xs_t[t - WINDOW:t]
        yw = feats_t[t + 1:t + 1 + HORIZON, :, :12].permute(1, 0, 2)
        opt.zero_grad()
        loss = crit(model(a_t, xw), yw)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), max_norm=1.0)
        opt.step()
        torch_losses.append(loss.item())

    # ---- port arm: the port's adaptation step ----------------------------
    port = init_model(torch.Generator().manual_seed(0), model_cfg).double()
    load_params(port, port_sd)
    assert sorted(port.state_dict()) == sorted(port_sd)
    tx, lr0_port = adaptation_optimizer(REGION)
    assert abs(lr0_port - lr0) < 1e-12
    tx = masked_freeze(tx, trainable_mask(dict(port.named_parameters()), model_cfg))
    state = SupervisedState(port, tx.init(dict(port.named_parameters())))
    step = make_train_step(model_cfg, tx)
    n_pad = graph.a_hat.shape[0]
    a_hat = torch.from_numpy(np.asarray(graph.a_hat, np.float64))
    node_mask = torch.zeros(n_pad, dtype=torch.float64)
    node_mask[:n] = 1.0
    feats_pad = torch.zeros((feats16.shape[0], n_pad, 16), dtype=torch.float64)
    feats_pad[:, :n] = torch.from_numpy(feats16.astype(np.float64))
    port_losses = []
    for t in anchors:
        t = int(t)
        x = feats_pad[t - WINDOW:t]
        y = feats_pad[t + 1:t + 1 + HORIZON, :, :12]
        state, loss = step(state, x, y, a_hat, node_mask, kcode, lr0, None)
        port_losses.append(float(loss))

    np.testing.assert_allclose(port_losses, torch_losses, rtol=1e-7)
    # The frozen Koppen table did not move.
    torch.testing.assert_close(port.koppen.detach(), port_sd["koppen"], rtol=0, atol=0)


def test_split_biases_load_and_forward_as_their_sum():
    """A state_dict with torch's two LSTM biases per layer loads through
    `load_params`, keeps both as parameters, and forwards as the model with
    their sum as its fused bias does."""
    from weatherforecast_stgcn_maml_tpu_torch.models.registry import apply_model

    cfg = ModelConfig(hidden_channels=HIDDEN, gcn_layers=GCN_LAYERS, lstm_hidden=LSTM_HIDDEN,
                      lstm_layers=LSTM_LAYERS, window=WINDOW, horizon=HORIZON,
                      koppen_dim=KOPPEN_DIM)
    fused = init_model(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    split_sd = {}
    for k, v in fused.state_dict().items():
        if k.startswith("lstm.") and k.endswith(".b"):
            b_hh = torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
            split_sd[k + "_ih"], split_sd[k + "_hh"] = v - b_hh, b_hh
        else:
            split_sd[k] = v
    split = init_model(torch.Generator().manual_seed(0), cfg)
    load_params(split, split_sd)
    names = dict(split.named_parameters())
    assert "lstm.layers.0.b_ih" in names and "lstm.layers.0.b" not in names
    x = torch.from_numpy(rng.normal(size=(WINDOW, 128, 16)).astype(np.float32))
    a_hat = torch.eye(128)
    with torch.no_grad():
        torch.testing.assert_close(apply_model(split, a_hat, x, 3, cfg),
                                   apply_model(fused, a_hat, x, 3, cfg), rtol=1e-6, atol=1e-6)
