"""16-block clusters and streamed slices in the LSTM cluster recurrences'
plans, on the CPU.

The plans are pure Python (`ops/fused_lstm_stack._cluster_plan`), asked off
the card by the tests and by `stack_planned` / `eval_planned`:

  * every plan a cluster of at most 8 blocks held before is unchanged: the
    forward (`forward_plan`), backward (`recurrence_plan`), tangent forward
    (`tangent_forward_plan`) and tangent backward (`tangent_plan`) plans on
    a grid of float32 and bfloat16 widths 32-256 (bfloat16 to 384), rows
    256-1536 and 1-4 tasks, against `_portable_plan`, the planner as it was
    with clusters of 1-8 only; and every plan a cluster of 1-16 blocks held
    is unchanged against `_wide_plan`, the planner with 16-block clusters
    and no streamed slices, with all K-rows resident;
  * the 16-block plans take 16 blocks of 32 weight columns at float32 H 320
    and 384 and bfloat16 H 448 and 512, within a block's shared memory;
    past them (float32 H 448, bfloat16 H 640) one task's forward and
    backward plans stream part of each slice (`stream_plans`: the cheapest
    by `plan_cost`, k_res < K, within shared memory), the tangent plans and
    V tasks still refuse;
  * `forward_weights` lays Wh out as the streamed forward's slices, against
    plain slicing;
  * `eval_plan` / `eval_planned` at validate's 1536 and the forecast's 512
    rows (item 13's rule: the cheaper of the 16-block plan and the streamed
    one, wherever a cluster holds Wh);
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
            plan = fn(*args)
        except ValueError:
            return None
        if len(plan) == 4:  # (cs, hcp, rb, k_res): resident plans compare as (cs, hcp, rb)
            return plan[:3] if plan[3] == (hidden if fn is fls.forward_plan else 4 * hidden) \
                else plan
        return plan

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


# (hidden, itemsize) -> (forward, backward) streamed plans (cs, hcp, rb,
# k_res) at 512 rows, one task: clusters of 8, most of each slice streamed
# (the cost model's choice, which the card's times agree with: PERF.md §6).
STREAMED = {
    (448, 4): ((8, 64, 16, 72), (8, 64, 8, 136)),
    (512, 4): ((8, 64, 16, 64), (8, 64, 8, 72)),
    (640, 2): ((8, 128, 8, 104), (8, 128, 8, 200)),
    (1024, 2): ((8, 128, 8, 96), (8, 128, 8, 8)),
}


@pytest.mark.parametrize("hidden,itemsize", list(STREAMED))
def test_widths_past_16_blocks_are_still_refused(hidden, itemsize):
    """Float32 H 448 and bfloat16 H 640 fit no cluster, 16 blocks included:
    the forward and backward recurrences take a streamed plan for one task
    (k_res of the K rows resident, the block within shared memory, k_res a
    multiple of 16 bytes' k values, the cheapest of `stream_plans`); V = 2
    tasks and the tangent recurrences (rows 10-11) still raise, naming the
    16-block limit."""
    for fn, k_rows, smem, got in (
            (fls.forward_plan, hidden, fls.scan_fwd_stream_smem, STREAMED[hidden, itemsize][0]),
            (fls.recurrence_plan, 4 * hidden, fls.scan_stream_smem,
             STREAMED[hidden, itemsize][1])):
        plan = fn(hidden, 512, itemsize, SMS)
        assert plan == got
        cs, hcp, rb, k_res = plan
        assert 0 <= k_res < k_rows and k_res % (16 // itemsize) == 0
        assert smem(hidden, hcp, rb, itemsize, k_res) <= fls.SCAN_MAX_SMEM
        assert plan == fls.stream_plans(hidden, 512, itemsize, SMS, fn is fls.forward_plan)[0]
        with pytest.raises(ValueError, match="in at most 16 blocks' shared memory"):
            fn(hidden, 512, itemsize, SMS, 2)
    for fn in (fused_lstm_hvp.tangent_forward_plan, fused_lstm_hvp.tangent_plan):
        with pytest.raises(ValueError, match="in at most 16 blocks' shared memory"):
            fn(hidden, 512, itemsize, SMS)


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
    assert fls.forward_plan(320, 8, 4, SMS) == (16, 32, 2, 320)
    assert fls.forward_plan(320, 16 * n, 4, SMS) == (16, 32, 16, 320)
    assert fls.recurrence_plan(320, 8, 4, SMS) == (16, 32, 2, 4 * 320)
    assert fls.recurrence_plan(320, 4 * n + 1, 4, SMS) == (16, 32, 4, 4 * 320)


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
    one (the training stack). `eval_planned` as given at the forecast's 512
    rows and validate's 1536."""
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


def _wide_plan(hidden, rows, sms, tasks, smem, row_tiles=(2, 4, 8, 16)):
    """The planner with 16-block clusters and no streamed slices: the
    portable planner, then a 16-block cluster only where no cluster of 1-8
    fits (its one wave: at most `H100_CLUSTERS_16` clusters); None where
    none fits."""
    plan = _portable_plan(hidden, rows, sms, tasks, smem, row_tiles)
    if plan is not None:
        return plan
    units = -(-hidden // 64) * 4
    hcp = next((p for p in (32, 64, 128) if p >= units), None)
    tiles = [rb for rb in row_tiles if hcp and smem(hcp, rb) <= fls.SCAN_MAX_SMEM]
    if not tiles:
        return None
    wave = [rb for rb in tiles if tasks * -(-rows // rb) <= fls.H100_CLUSTERS_16]
    return 16, hcp, (wave or tiles[-1:])[0]


def _wide_forward_plan(hidden, rows, itemsize, sms, tasks):
    """`forward_plan` with 16-block clusters and no streamed slices: the
    32-row retry for one task in the plan's kind of cluster."""
    smem = _fwd_smem(hidden, itemsize)
    plan = _wide_plan(hidden, rows, sms, tasks, smem)
    if plan is None or tasks > 1 or fls._one_wave(plan, rows, tasks, sms):
        return plan
    narrow = lambda hcp, rb: smem(hcp, rb) if hcp <= 16 * itemsize else fls.SCAN_MAX_SMEM + 1
    wide = (_wide_plan if plan[0] == 16 else _portable_plan)(
        hidden, rows, sms, tasks, narrow, row_tiles=(fls.FWD_WIDE_TILE,))
    return wide if wide is not None and fls._one_wave(wide, rows, tasks, sms) else plan


@pytest.mark.parametrize("itemsize,widths", [
    (4, [*range(32, 513, 32), 392, 396, 400, 436, 440]),
    (2, [*range(32, 705, 32), 520]),
])
def test_plans_with_a_cluster_of_1_to_16_are_unchanged(itemsize, widths):
    """The plan rule's table: wherever a cluster of 1-16 blocks held Wh
    (the planner before streamed slices, `_wide_plan`), at rows 256-1536
    and 1-2 tasks, the forward and backward plans are its plans with every
    K-row resident (k_res = K); where none held it, one task streams (k_res
    < K) and two tasks still raise."""
    for hidden in widths:
        for rows in (256, 512, 1024, 1536):
            for tasks in (1, 2):
                for fn, k_rows, old in (
                        (fls.forward_plan, hidden,
                         _wide_forward_plan(hidden, rows, itemsize, SMS, tasks)),
                        (fls.recurrence_plan, 4 * hidden,
                         _wide_plan(hidden, rows, SMS, tasks, _bwd_smem(hidden, itemsize)))):
                    where = (fn.__name__, hidden, rows, tasks)
                    if old is not None:
                        assert fn(hidden, rows, itemsize, SMS, tasks) == (*old, k_rows), where
                    elif tasks == 1:
                        assert fn(hidden, rows, itemsize, SMS, tasks)[3] < k_rows, where
                    else:
                        with pytest.raises(ValueError):
                            fn(hidden, rows, itemsize, SMS, tasks)


@pytest.mark.parametrize("hidden,cs,hcp,dtype", [
    (12, 2, 32, torch.float32),     # hc 8: two blocks, padded to 32 columns
    (40, 4, 32, torch.float32),     # hc 12: the last block owns 4 units
    (48, 16, 32, torch.bfloat16),   # hc 4: blocks past H own no unit (zeros)
    (448, 8, 64, torch.float32),    # the float32 H 448 streamed plan's layout
])
def test_forward_weights_lay_out_the_streamed_slices(hidden, cs, hcp, dtype):
    """`forward_weights` [cs, H, 4, hcp] against plain slicing: block b, row
    k, gate q, column u is Wh[k, q*H + b*hc + u] (rounded to the compute
    dtype) for the block's units, zero past them; a leading task axis lays
    out each task's alike."""
    wh = torch.randn((2, hidden, 4 * hidden), generator=torch.Generator().manual_seed(hidden))
    got = fls.forward_weights(wh, cs, hcp, dtype)
    assert got.shape == (2, cs, hidden, 4, hcp) and got.dtype == dtype and got.is_contiguous()
    hc = fls.scan_units(hidden, cs)
    want = torch.zeros((2, cs, hidden, 4, hcp), dtype=dtype)
    for b in range(cs):
        n = max(0, min(hc, hidden - b * hc))
        for q in range(4):
            want[:, b, :, q, :n] = wh[:, :, q * hidden + b * hc:q * hidden + b * hc + n].to(dtype)
    assert torch.equal(got, want)
    assert torch.equal(fls.forward_weights(wh[0], cs, hcp, dtype), want[0])


# Item 13's rule at validate's [1536, 24, 256] and the forecast's [512, 24,
# 256], float32: (hidden, rows) -> (`eval_plan`, `eval_planned`).
EVAL_RULE = {
    (128, 1536): ((2, 64, 32, 128), True),   # a cluster of 2 holds Wh: forward_plan's
    (128, 512): ((2, 64, 8, 128), True),
    (320, 1536): ((8, 64, 16, 88), True),    # the streamed plan beats 16 blocks
    (320, 512): ((8, 64, 16, 88), True),     # the streamed plan, 2 waves
    (384, 1536): ((8, 64, 16, 80), True),
    (384, 512): ((8, 64, 16, 80), True),
    (448, 1536): ((8, 64, 16, 72), False),   # no cluster holds Wh: auto runs plain
    (448, 512): ((8, 64, 16, 72), False),
}


@pytest.mark.parametrize("hidden,rows", list(EVAL_RULE))
def test_eval_planned_rule_at_the_serving_rows(hidden, rows):
    """`eval_plan`: `forward_plan`'s plan unless that is a 16-block one,
    then the cheaper by `plan_cost` of it and the cheapest streamed plan;
    `eval_planned` (the route of `auto` and `use_pallas_lstm`): True where a
    cluster holds Wh, False past them (the forced routes still take the
    streamed plan there)."""
    plan, planned = EVAL_RULE[hidden, rows]
    assert fls.eval_plan(hidden, rows, 4, SMS) == plan
    assert fls.eval_planned(256, hidden, rows, torch.float32, CPU) is planned
    resident = fls.forward_plan(hidden, rows, 4, SMS)
    if resident[0] < 16:
        assert plan == resident
    elif resident[3] == hidden:
        cost = lambda p: fls.plan_cost(p, hidden, rows, 4, SMS, True)
        assert cost(plan) <= cost(resident)
        assert planned
    else:
        assert plan == resident == fls.stream_plans(hidden, rows, 4, SMS, True)[0]
