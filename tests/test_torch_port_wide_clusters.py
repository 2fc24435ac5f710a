"""16-block clusters in the four LSTM cluster recurrences' plans, on the CPU.

The plans are pure Python (`ops/fused_lstm_stack._cluster_plan`), asked off
the card by the tests and by `stack_planned` / `eval_planned`:

  * every plan a cluster of at most 8 blocks held before is unchanged: the
    forward (`forward_plan`), backward (`recurrence_plan`), tangent forward
    (`tangent_forward_plan`) and tangent backward (`tangent_plan`) plans on
    a grid of float32 and bfloat16 widths 32-256 (bfloat16 to 384), rows
    256-1536 and 1-4 tasks, against `_portable_plan`, the planner as it was
    with clusters of 1-8 only;
  * the new plans take 16 blocks of 32 weight columns at float32 H 320 and
    384 and bfloat16 H 448 and 512, within a block's shared memory, and
    every recurrence still refuses float32 H 448 and bfloat16 H 640;
  * the routing answers follow: `stack_planned` and `eval_planned` say True
    at the new widths and False past them, and wherever the training stack
    is planned rows 10-11's tangent plans exist too (second order's fused
    gradient runs them behind `stack_planned`);
  * the forced routes and `use_pallas_lstm` reach their entries at float32
    H 320 and 384 (the card's launches are `tests/test_torch_port_cuda.py`'s
    and `chip_smoke.py`'s), and `auto` takes the training stack there.
"""

import pytest
import torch

from weatherforecast_stgcn_maml_tpu_torch.models import lstm as tlstm
from weatherforecast_stgcn_maml_tpu_torch.models.common import draw_mask
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm, fused_lstm_hvp
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls

torch.set_num_threads(1)  # small tensors; more threads oversubscribe side-by-side workers

SMS = fls.H100_SMS
CPU = torch.device("cpu")


def _fwd_smem(h, itemsize):
    return lambda hcp, rb: fls.scan_fwd_smem(h, hcp, rb, itemsize)


def _bwd_smem(h, itemsize):
    return lambda hcp, rb: fls.scan_smem(h, hcp, rb, itemsize)


def _portable_plan(hidden, rows, sms, tasks, smem, row_tiles=(2, 4, 8, 16)):
    """The cluster planner before 16-block clusters: the smallest of 1, 2,
    4 and 8 blocks whose slice fits beside a row tile that puts every
    cluster on the SMs in one wave (the smallest such tile), else the
    smallest that fits, with its largest tile; None where none fits."""
    fallback = None
    for cs in (1, 2, 4, 8):
        units = -(-hidden // (4 * cs)) * 4
        hcp = next((p for p in (32, 64, 128) if p >= units), None)
        if hcp is None:
            continue
        tiles = [rb for rb in row_tiles if smem(hcp, rb) <= fls.SCAN_MAX_SMEM]
        if not tiles:
            continue
        wave = [rb for rb in tiles if tasks * -(-rows // rb) * cs <= sms]
        if wave:
            return cs, hcp, wave[0]
        fallback = fallback or (cs, hcp, tiles[-1])
    return fallback


def _portable_forward_plan(hidden, rows, itemsize, sms, tasks):
    """`forward_plan` before 16-block clusters: the 32-row tile for one task
    where it alone reaches one wave, at hcp <= 16 x itemsize."""
    smem = _fwd_smem(hidden, itemsize)
    plan = _portable_plan(hidden, rows, sms, tasks, smem)
    if plan is None or tasks > 1 or tasks * -(-rows // plan[2]) * plan[0] <= sms:
        return plan
    wide = _portable_plan(
        hidden, rows, sms, tasks,
        lambda hcp, rb: smem(hcp, rb) if hcp <= 16 * itemsize else fls.SCAN_MAX_SMEM + 1,
        row_tiles=(fls.FWD_WIDE_TILE,))
    if wide is None or tasks * -(-rows // wide[2]) * wide[0] > sms:
        return plan
    return wide


def _plans(hidden, rows, itemsize, tasks):
    """(name, new plan or None where it raises, portable plan) for each
    recurrence; the tangent recurrences plan one task."""
    def ask(fn, *args):
        try:
            return fn(*args)
        except ValueError:
            return None

    out = [
        ("forward", ask(fls.forward_plan, hidden, rows, itemsize, SMS, tasks),
         _portable_forward_plan(hidden, rows, itemsize, SMS, tasks)),
        ("backward", ask(fls.recurrence_plan, hidden, rows, itemsize, SMS, tasks),
         _portable_plan(hidden, rows, SMS, tasks, _bwd_smem(hidden, itemsize))),
    ]
    if tasks == 1:
        out += [
            ("tangent forward", ask(fused_lstm_hvp.tangent_forward_plan, hidden, rows, itemsize,
                                    SMS),
             _portable_plan(hidden, rows, SMS, 1, _fwd_smem(hidden, itemsize), (2, 4, 8))),
            ("tangent backward", ask(fused_lstm_hvp.tangent_plan, hidden, rows, itemsize, SMS),
             _portable_plan(hidden, rows, SMS, 1, _bwd_smem(hidden, itemsize), (2, 4, 8))),
        ]
    return out


@pytest.mark.parametrize("itemsize,widths", [
    (4, range(32, 257, 32)),   # float32: 32-256, every width a portable cluster holds
    (2, range(32, 385, 32)),   # bfloat16: 32-384
])
def test_plans_with_a_portable_cluster_are_unchanged(itemsize, widths):
    """At every width a cluster of at most 8 blocks holds, on rows 256-1536
    and 1-4 tasks, each recurrence's plan is the portable planner's."""
    for hidden in widths:
        for rows in (256, 441, 512, 768, 1024, 1536):
            for tasks in (1, 2, 3, 4):
                for name, got, want in _plans(hidden, rows, itemsize, tasks):
                    assert want is not None and got == want, (name, hidden, rows, tasks)
                    assert got[0] <= 8


# (hidden, itemsize) -> {recurrence: (cs, hcp, rb)} at 512 rows, one task:
# Wh's 4H x H split over 16 blocks of hc <= 32 units, the largest row tile
# beside it (no tile puts 32 or more 16-block clusters in one wave).
NEW_PLANS = {
    (320, 4): {"forward": (16, 32, 16), "backward": (16, 32, 4),
               "tangent forward": (16, 32, 8), "tangent backward": (16, 32, 4)},
    (384, 4): {"forward": (16, 32, 8), "backward": (16, 32, 2),
               "tangent forward": (16, 32, 8), "tangent backward": (16, 32, 2)},
    (448, 2): {"forward": (16, 32, 16), "backward": (16, 32, 8),
               "tangent forward": (16, 32, 8), "tangent backward": (16, 32, 8)},
    (512, 2): {"forward": (16, 32, 16), "backward": (16, 32, 8),
               "tangent forward": (16, 32, 8), "tangent backward": (16, 32, 8)},
}


@pytest.mark.parametrize("hidden,itemsize", list(NEW_PLANS))
def test_new_plans_take_16_block_clusters(hidden, itemsize):
    """Where no cluster of 8 holds Wh, each recurrence takes 16 blocks of
    32 weight columns, its shared memory within a block's 227 KB; the
    smaller row tiles at 1536 rows and for 2 tasks keep 16 blocks."""
    for name, got, want in _plans(hidden, 512, itemsize, 1):
        assert want is None, name  # no portable cluster held it
        assert got == NEW_PLANS[(hidden, itemsize)][name], name
        smem = (fls.scan_fwd_smem if "forward" in name else fls.scan_smem)(
            hidden, got[1], got[2], itemsize)
        assert smem <= fls.SCAN_MAX_SMEM, name
    for rows, tasks in ((1536, 1), (512, 2), (256, 4)):
        for name, got, _ in _plans(hidden, rows, itemsize, tasks):
            assert got is not None and got[:2] == (16, 32), (name, rows, tasks)


@pytest.mark.parametrize("hidden,itemsize", [(448, 4), (512, 4), (640, 2), (1024, 2)])
def test_widths_past_16_blocks_are_still_refused(hidden, itemsize):
    """Float32 H 448 and bfloat16 H 640 fit no cluster, 16 blocks included:
    every recurrence raises, naming the 16-block limit."""
    for fn, args in ((fls.forward_plan, (SMS,)), (fls.recurrence_plan, (SMS,)),
                     (fused_lstm_hvp.tangent_forward_plan, (SMS,)),
                     (fused_lstm_hvp.tangent_plan, (SMS,))):
        with pytest.raises(ValueError, match="in at most 16 blocks' shared memory"):
            fn(hidden, 512, itemsize, *args)


def test_one_wave_counts_16_block_clusters_by_the_card():
    """A 16-block plan is one wave where its clusters are at most the
    H100's `H100_CLUSTERS_16`, not where 16 x clusters <= SMs; the portable
    sizes keep the block count."""
    n = fls.H100_CLUSTERS_16
    assert 16 * n <= SMS
    assert fls._one_wave((16, 32, 16), 16 * n, 1, SMS)
    assert not fls._one_wave((16, 32, 16), 16 * n + 1, 1, SMS)
    assert not fls._one_wave((16, 32, 16), 16, n + 1, SMS)
    assert fls._one_wave((8, 32, 8), 8 * 16, 1, SMS)
    # a 16-block plan that reaches one wave takes its smallest such tile,
    # else its largest
    assert fls.forward_plan(320, 8, 4, SMS) == (16, 32, 2)
    assert fls.forward_plan(320, 16 * n, 4, SMS) == (16, 32, 16)
    assert fls.recurrence_plan(320, 8, 4, SMS) == (16, 32, 2)
    assert fls.recurrence_plan(320, 4 * n + 1, 4, SMS) == (16, 32, 4)


@pytest.mark.parametrize("dtype,hidden,planned,eval_planned", [
    (torch.float32, 320, True, True), (torch.float32, 384, True, True),
    (torch.float32, 392, True, True), (torch.float32, 400, False, True),
    (torch.float32, 448, False, False), (torch.bfloat16, 448, True, True),
    (torch.bfloat16, 512, True, True), (torch.bfloat16, 640, False, False),
])
def test_routing_answers_at_the_new_widths(dtype, hidden, planned, eval_planned):
    """`stack_planned` (one task and V = 2, 512 and 1536 rows) and
    `eval_planned` at the widths 16-block clusters opened and past them:
    float32 H 400-436 has a forward plan (the eval forward) but no backward
    one (the training stack)."""
    for rows in (512, 1536):
        assert fls.stack_planned(hidden, rows, dtype, CPU) is planned
        assert fls.stack_planned(hidden, rows, dtype, CPU, tasks=2) is planned
        assert fls.stack_planned(hidden, rows, dtype, CPU, c_in=256) is planned
        assert fls.eval_planned(256, hidden, rows, dtype, CPU) is eval_planned


def test_tangent_plans_exist_wherever_the_stack_is_planned():
    """Second order's fused gradient runs rows 10-11 behind `stack_planned`:
    at every width (multiples of 8 up to float32 448 and bfloat16 640) and
    row count where the training stack is planned, both tangent plans
    exist."""
    for dtype, top in ((torch.float32, 448), (torch.bfloat16, 640)):
        for hidden in range(8, top + 1, 8):
            for rows in (128, 256, 512, 1024, 1536):
                if fls.stack_planned(hidden, rows, dtype, CPU):
                    fused_lstm_hvp.tangent_forward_plan(hidden, rows, dtype.itemsize, SMS)
                    fused_lstm_hvp.tangent_plan(hidden, rows, dtype.itemsize, SMS)


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("hidden", [320, 384])
def test_routes_reach_their_entries_at_16_block_widths(monkeypatch, hidden):
    """At float32 H 320 and 384: `auto` and `pallas_stack` call the training
    stack's entry, `pallas` the per-layer route, `auto` in eval mode the
    eval forward's entry and `use_pallas_lstm`'s row 20 its own, none
    counted as a plain route; each equals the plain stack (a CPU tensor runs
    the plain pieces)."""
    t_len, rows, c_in = 3, 4, 8
    lstm = tlstm.init_lstm(torch.Generator().manual_seed(0), c_in, hidden, 2)
    x = torch.randn((rows, t_len, c_in), generator=torch.Generator().manual_seed(1))
    masks = draw_mask(torch.Generator().manual_seed(2), (1, t_len, rows, hidden), 0.2, CPU)
    train = _spy(monkeypatch, tlstm, "lstm_stack_train")
    layerwise = _spy(monkeypatch, tlstm, "lstm_layerwise")
    last = _spy(monkeypatch, tlstm, "lstm_stack_last_all")
    before = fls.lstm_stack_train.plain_routes
    ref = fls.lstm_stack_plain(lstm.layers, x, torch.float32, masks, 0.8)
    for kernel in ("auto", "pallas_stack", "pallas"):
        got = tlstm.apply_lstm(lstm, x, train=True, masks=masks, dropout_rate=0.2,
                               compute_dtype=torch.float32, kernel=kernel)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, msg=kernel)
    with torch.no_grad():
        tlstm.apply_lstm(lstm, x, compute_dtype=torch.float32, kernel="auto")
    assert (train, layerwise, last) == (["lstm_stack_train"] * 2, ["lstm_layerwise"],
                                        ["lstm_stack_last_all"])
    assert fls.lstm_stack_train.plain_routes == before
    assert fls.eval_planned(c_in, hidden, rows, torch.float32, CPU)
    with torch.no_grad():
        torch.testing.assert_close(
            fused_lstm.fused_lstm_last_hidden(lstm.layers, x, compute_dtype=torch.float32),
            fls.lstm_stack_plain(lstm.layers, x, torch.float32), rtol=1e-5, atol=1e-6)
