#!/usr/bin/env python3
"""Times of the LSTM cluster recurrences' plans on one card: the streamed
plans against each other and against the resident ones, and the eval
forward's three routes at the widths where a 16-block cluster holds Wh.

  python3 tools/stream_plans.py [--out FILE] [--recurrences-only]

Each plan is forced in turn (`fused_lstm_stack.forward_plan`, `eval_plan`
and `recurrence_plan` swapped in process) and held against the plain
version before it is timed, by CUDA graph replay (median of 10):

  1. the eval forward (`lstm_stack_last_all`: rows 2 and 20's schedule) at
     validate's [1536, 24, 256] and the forecast's [512, 24, 256], 4 layers,
     float32 H 320 and 384 and bfloat16 H 512: its 16-block plan, its three
     cheapest streamed plans (`stream_plans`) and the plain stack, in turns
     (every route, then every route again in reverse order; the mean of
     the two), each by CUDA events around eager calls (what a caller waits:
     the plain stack's ~12 launches a step are host-bound) and by graph
     replay;
  2. the forward and backward recurrences alone (24 steps, 512 rows) at
     float32 H 128 (a cluster of 2), 320 and 384 (16 blocks), 448, 512 and
     1024 and bfloat16 H 640 and 1024 (streamed: the four cheapest plans);
     the backward with the bias gradient's partials, as rows 5 and 15 run
     it.

Beside each time it prints the cost model's (`plan_cost`) and, at the end,
the model's constants fitted to the recurrences' times by least squares (a
step's fixed cost for clusters of at most 8 and of 16, the model's
`STEP_US` where they agree; `FMA_PER_US`; `L2_BYTES_PER_US`). The numbers
also go to FILE as JSON (default out/stream_plans.json). The card's
name and power limit lead the output. It exits 1 where a plan disagrees
with the plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from weatherforecast_stgcn_maml_tpu_torch.models.lstm import init_lstm  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops import fused_lstm_stack as fls  # noqa: E402
from weatherforecast_stgcn_maml_tpu_torch.ops.lstm_scan import scan_backward_plain  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
T_LEN, C_IN, LAYERS = 24, 256, 4


def graph_ms(fn, repeats=10):
    """fn's device time in ms: captured once in a CUDA graph, its replays
    timed by CUDA events (median)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


@contextlib.contextmanager
def forced(plan):
    """Every recurrence plan asked in the block is `plan`."""
    saved = fls.forward_plan, fls.eval_plan, fls.recurrence_plan
    fls.forward_plan = fls.eval_plan = fls.recurrence_plan = lambda *a, **k: plan
    try:
        yield
    finally:
        fls.forward_plan, fls.eval_plan, fls.recurrence_plan = saved


def events_ms(fn, repeats=10):
    """fn's time in ms by CUDA events around eager calls (median)."""
    fn()
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def eval_routes(dev, dtype, hidden, rows, out):
    """Section 1 at one shape: the 16-block plan, the streamed plans and the
    plain stack, in turns."""
    e = dtype.itemsize
    sms = fls._sms(dev)
    lstm = init_lstm(torch.Generator().manual_seed(hidden), C_IN, hidden, LAYERS).to(dev)
    x = torch.from_numpy(np.random.default_rng(hidden).normal(
        size=(rows, T_LEN, C_IN)).astype(np.float32)).to(dev)
    with torch.no_grad():
        ref = fls.lstm_stack_plain(lstm.layers, x, dtype)
        routes = {"plain": lambda: fls.lstm_stack_plain(lstm.layers, x, dtype)}
        plans = [fls.forward_plan(hidden, rows, e, sms),
                 *fls.stream_plans(hidden, rows, e, sms, True)[:3]]
        for plan in plans:
            with forced(plan):
                got = fls.lstm_stack_last_all(lstm.layers, x, compute_dtype=dtype)
            err = float((got - ref).abs().max())
            if err > TOL[dtype] * (1 + float(ref.abs().max())):
                raise RuntimeError(f"eval forward {plan} at {dtype} H {hidden}: {err}")

            def run(plan=plan):
                with forced(plan):
                    fls.lstm_stack_last_all(lstm.layers, x, compute_dtype=dtype)

            routes[str(plan)] = run
        order = list(routes)
        times = {k: [] for k in order}
        graphs = {k: [] for k in order}
        for turn in (order, order[::-1]):
            for k in turn:
                times[k].append(events_ms(routes[k]))
                graphs[k].append(graph_ms(routes[k]))
    for k in order:
        ms = statistics.mean(times[k])
        model = None
        if k != "plain":
            plan = tuple(int(v) for v in k.strip("()").split(", "))
            model = fls.plan_cost(plan, hidden, rows, e, sms, True) * T_LEN * LAYERS / 1e3
        out.append({"section": "eval", "dtype": str(dtype)[6:], "hidden": hidden, "rows": rows,
                    "route": k, "ms": ms, "turns": times[k], "graph_ms": graphs[k],
                    "model_ms": model})
        print(f"eval {str(dtype)[6:]} H {hidden} [{rows}, {T_LEN}, {C_IN}] {k}: {ms:.4f} ms "
              f"by events (turns {[round(t, 4) for t in times[k]]}), graph replay "
              f"{[round(t, 4) for t in graphs[k]]}"
              + (f", model {model:.4f} ms" if model is not None else ""), flush=True)


def recurrences(dev, dtype, hidden, rows, out, n_plans=4):
    """Section 2 at one width: the forward and backward recurrences alone
    on their resident plan or their cheapest streamed plans."""
    e = dtype.itemsize
    sms = fls._sms(dev)
    g4 = 4 * hidden
    draw = np.random.default_rng(hidden)

    def card(*shape, scale=1.0):
        return torch.from_numpy((draw.normal(size=shape) * scale).astype(np.float32)).to(dev)

    xp, bias = card(T_LEN, rows, g4), card(g4, scale=0.1)
    wh = card(hidden, g4, scale=hidden ** -0.5)
    for forward in (True, False):
        resident = (fls.forward_plan if forward else fls.recurrence_plan)(hidden, rows, e, sms)
        plans = ([resident] if resident[3] == (hidden if forward else g4)
                 else fls.stream_plans(hidden, rows, e, sms, forward)[:n_plans])
        if forward:
            res = [torch.empty((T_LEN, rows, hidden), dtype=dtype, device=dev) for _ in range(2)]
            gates = xp.clone()
            fls._forward_recurrence_plain(gates, wh, bias, dtype, *res)
            ref = gates

            def run():
                g = xp.clone()
                fls._forward_recurrence_card(g, wh, bias, dtype, *res)
                return g
        else:
            pre = draw.normal(size=(T_LEN, rows, 4, hidden))
            act = np.concatenate([1 / (1 + np.exp(-pre[:, :, :2])), np.tanh(pre[:, :, 2:3]),
                                  1 / (1 + np.exp(-pre[:, :, 3:]))], axis=2)
            gts = torch.from_numpy(act.reshape(T_LEN, rows, g4).astype(np.float32)).to(dev)
            c, gr = card(T_LEN, rows, hidden).to(dtype), card(T_LEN, rows, hidden)
            ref = scan_backward_plain(gr, gts, c, wh, dtype)
            dg, db = torch.empty_like(gts), torch.empty((g4,), device=dev)

            def run():
                fls._recurrence_card(gr, gts, c, wh, dtype, dg, db=db)
                return dg
        for plan in plans:
            with forced(plan):
                err = rel_err(run(), ref)
                if err > TOL[dtype]:
                    raise RuntimeError(f"{'forward' if forward else 'backward'} {plan} at "
                                       f"{dtype} H {hidden}: {err}")
                ms = graph_ms(run)
            model = fls.plan_cost(plan, hidden, rows, e, sms, forward) * T_LEN / 1e3
            k_rows = hidden if forward else g4
            row = fls._slice_row_bytes(plan[1], e, forward)
            out.append({"section": "recurrence", "forward": forward, "dtype": str(dtype)[6:],
                        "hidden": hidden, "rows": rows, "plan": plan, "ms": ms,
                        "model_ms": model, "max_rel_err": err,
                        "streamed_bytes_a_block": (k_rows - plan[3]) * row})
            print(f"{'forward' if forward else 'backward'} {str(dtype)[6:]} H {hidden}, "
                  f"{rows} rows, plan {plan} (k_res {plan[3]} of {k_rows}): {ms:.4f} ms, "
                  f"model {model:.4f} ms, max rel err {err:.2e}", flush=True)


def fit(out, sms):
    """Least squares of the cost model's constants on the recurrences'
    times: us a step = waves x (c0[cs == 16] + fmas / F + bytes / L)."""
    rows_a, rhs = [], []
    for r in out:
        if r["section"] != "recurrence":
            continue
        cs, hcp, rb, k_res = r["plan"]
        h, fwd = r["hidden"], r["forward"]
        k_rows = h if fwd else 4 * h
        waves = fls._waves(cs, -(-r["rows"] // rb), sms)
        fmas = rb * k_rows * (4 * hcp if fwd else hcp)
        rows_a.append([waves * (cs < 16), waves * (cs == 16), waves * fmas,
                       waves * r["streamed_bytes_a_block"]])
        rhs.append(r["ms"] * 1e3 / T_LEN)
    coef, *_ = np.linalg.lstsq(np.array(rows_a, float), np.array(rhs), rcond=None)
    fitted = {"STEP_US": {"portable": coef[0], "16": coef[1]},
              "FMA_PER_US": 1 / coef[2] if coef[2] > 0 else None,
              "L2_BYTES_PER_US": 1 / coef[3] if coef[3] > 0 else None}
    print("cost model fitted to the recurrences' times: " + json.dumps(fitted), flush=True)
    return fitted


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join("out", "stream_plans.json"))
    ap.add_argument("--recurrences-only", action="store_true",
                    help="section 2 alone (the recurrences), not the eval forward's routes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_plans: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: list = []
    try:
        for dtype, hidden in ((torch.float32, 320), (torch.float32, 384), (torch.bfloat16, 512)):
            for rows in (1536, 512) if not args.recurrences_only else ():
                eval_routes(dev, dtype, hidden, rows, out)
        for dtype, hidden in ((torch.float32, 128), (torch.float32, 320), (torch.float32, 384),
                              (torch.float32, 448), (torch.float32, 512), (torch.float32, 1024),
                              (torch.bfloat16, 640), (torch.bfloat16, 1024)):
            recurrences(dev, dtype, hidden, 512, out)
    except RuntimeError as err:
        print(f"stream_plans: {err}", file=sys.stderr)
        return 1
    fitted = fit(out, fls._sms(dev))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": out, "fitted": fitted}, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
