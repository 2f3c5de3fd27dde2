#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. the card: name and power limit (``nvidia-smi``), TF32 off;
2. build the kernels from ``differt2d_tpu_torch/ops/csrc`` (``nvcc``);
3. the main path: ``power_map`` of ``Scene.basic_scene()`` on a 1024 x 1024
   receiver grid (order <= 1, soft logic, hard_sigmoid, alpha 100), as a
   value map and as a value + pixel-gradient map, through the entry point a
   user calls; the launch counters are zeroed just before and read just
   after, and each kernel's output is held against its plain PyTorch
   version on the same inputs on the card (values at rtol 1e-4 / atol 1e-5,
   gradients under the kink contract at rtol 1e-3 / atol 1e-5);
4. coverage at 256 x 256: hard logic, the sigmoid activation, a square
   scene with a RIS and a vertex, two transmitters, transmitter grids and
   order 2, each against the plain version;
5. autograd through the value kernel: gradients of the map's sum with
   respect to the transmitter, the walls and alpha, against the plain
   version's autograd;
6. timing with CUDA events (32 maps chained without a host sync, median of
   5 repeats), each kernel's bound, and the plain version's time.

It prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` JSON line,
and, last, ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

VALUE_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
REPLACES = "differt2d_tpu/ops/pallas_kernels.py:362"
SOURCE = "differt2d_tpu_torch/ops/csrc/power_map.cu"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def import_port() -> None:
    """Import the package of this checkout (never one installed elsewhere)."""
    sys.path.insert(0, ROOT)
    try:
        import differt2d_tpu_torch
    except ImportError as exc:
        fail(f"differt2d_tpu_torch not found beside chip_smoke.py ({exc})")
    pkg_dir = os.path.dirname(os.path.abspath(differt2d_tpu_torch.__file__))
    check(pkg_dir == os.path.join(ROOT, "differt2d_tpu_torch"),
          f"imported differt2d_tpu_torch from {pkg_dir}, not this checkout")


def grid(n: int, device):
    import torch

    x = torch.linspace(0.01, 0.99, n, device=device)
    y = torch.linspace(0.012, 0.988, n, device=device)
    return torch.meshgrid(x, y, indexing="xy")


def max_abs(a, b) -> float:
    return float((a - b).abs().max().detach())


def assert_close(name, got, ref, tol=VALUE_TOL) -> float:
    import torch

    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    ok = torch.allclose(got, ref, **tol)
    err = max_abs(got, ref)
    # Worst ratio of error to allowance: under 1 passes.
    worst = float(((got - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max().detach())
    check(ok, f"{name}: max abs err {err} beyond {tol} (worst ratio {worst:.3g})")
    print(f"  {name}: max abs err {err:.3g}, worst err/allowance {worst:.3g}", flush=True)
    return err


def assert_kinks(name, got, ref) -> float:
    import torch

    from differt2d_tpu_torch.utils import kink_excess

    check(bool(torch.isfinite(got).all()), f"{name}: non-finite gradients")
    n_bad, allowed = kink_excess(got, ref, **GRAD_TOL)
    check(n_bad <= allowed, f"{name}: {n_bad} gradient elements beyond kink allowance {allowed}")
    print(f"  {name}: {n_bad} kink elements (allowed {allowed:.0f})", flush=True)
    return max_abs(got, ref)


def cuda_time_ms(fn, k: int, reps: int) -> float:
    """Median over ``reps`` of the mean ms per call of ``k`` chained calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


# Operations the main path's map needs (soft logic, hard_sigmoid), counted
# by hand: one per float add, sub, mul, div, sqrt or exp; selects, compares
# and min/max are free.  Each value is counted once, where it first depends
# on the pixel, whatever the kernel repeats: per-wall values (direction,
# unit normal, patched ends and their direction, a.n, 1/|b - a|^2, sin/cos
# of the RIS phase) and the transmitter's mirror images are formed once per
# launch, a segment's vector once per segment, and the blocked test takes
# the folded form of pallas_kernels._seg_intersect_m6 (z = num * (alpha /
# den), margins z + c1 and c2 - z with c1, c2 once per launch).  The
# gradient of a max or min needs the selected argument's partials only, so
# the blocked test's partials are counted once per candidate, not per wall.
OPS_PER_WALL = 22    # per launch: direction 2, |d|^2 3, sqrt and normal 3,
#                      1/|d|^2 1, a.n 3, patched ends 8, sin/cos 2
OPS_PER_IMAGE = 12   # per launch, transmitter and bounce: mirror 9, image.n 3
OPS_BOUNCE = 12      # backward image step: p.n 3, un 1, vn 1, vn/un 1, u 2, p + s u 4
OPS_SEGMENT = 8      # vector 2, length |v + eps| 6 (plus one add per extra segment)
OPS_LOSS = {0: 25, 1: 17}  # wall: two unit vectors 12, reflect 8, |e|^2 5;
#                            RIS: unit vector 6, sin/cos 6, |e|^2 5
OPS_ON = 9           # t = (p - a).d / |d|^2 6, two margins 3
OPS_GATE = 2         # loss gate margin (alpha tol + 3) - alpha loss
OPS_TEST = 18        # blocked test: a - c 2, num_a, num_b, den 9, alpha/den 1,
#                      z_a, z_b 2, four margins 4
OPS_VALID_POWER = 7  # folded validity 2, r^2 + h^2 and division 3, valid * power 1, sum 1
# With the pixel gradient:
OPS_JACOBIAN = 12    # rank-1 bounce Jacobian: f 1, g 4, d - g n 4, scale 3
OPS_ON_GRAD = 2      # slope times the bounce's rank-1 gradient
OPS_LOSS_GRAD_RIS = 31  # 2e weights 8, rw 3, q 6, two contractions 10, sum 4
OPS_BLOCK_GRAD = 18  # selected wall's partials 14, times the slope 4
OPS_CONTRACT = 7     # per bounce end of that segment: k 3, two products 2, sum 2
OPS_POWER_GRAD = 15  # dP/dr 3, unit vector 2, products 2, value rule 6, sum 2


def ops_count(groups: dict, kinds: tuple, n_tx: int, with_grad: bool) -> tuple[int, int]:
    """``(per pixel, per launch)`` operations of the main path's map."""
    wall_kinds = [k for k in kinds if k != 2]
    per_pixel, per_launch = 0, OPS_PER_WALL * len(kinds)
    for order, cands in groups.items():
        for row in cands:
            row = [int(i) for i in row]
            bounces = [kinds[i] for i in row if kinds[i] != 2]
            ids = [-1, *row, -1]
            tested = sum(
                len(wall_kinds) - sum(1 for w in {ids[s], ids[s + 1]} if w >= 0 and kinds[w] != 2)
                for s in range(order + 1)
            )
            f = OPS_SEGMENT * (order + 1) + order + OPS_TEST * tested + OPS_VALID_POWER
            f += sum(OPS_BOUNCE + OPS_LOSS[k] + OPS_ON for k in bounces)
            f += OPS_GATE if bounces else 0
            if with_grad:
                f += sum(OPS_JACOBIAN + OPS_ON_GRAD + (OPS_LOSS_GRAD_RIS if k == 1 else 0)
                         for k in bounces)
                f += OPS_BLOCK_GRAD + (OPS_CONTRACT if bounces else 0) + OPS_POWER_GRAD
            per_pixel += f
            per_launch += OPS_PER_IMAGE * len(bounces) * n_tx
    return per_pixel * n_tx + (n_tx - 1) * (3 if with_grad else 1), per_launch


def main() -> int:
    import torch

    # -- 1. the card -------------------------------------------------------
    try:
        card, smi_error = smi("name,power.limit"), None
    except (OSError, subprocess.SubprocessError) as exc:
        card, smi_error = None, exc
    if card is not None:
        print(card, flush=True)
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    check(card is not None, f"nvidia-smi could not read the card ({smi_error})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind} x{count}", flush=True)

    import_port()
    from differt2d_tpu_torch import Scene, power_map
    from differt2d_tpu_torch.logic import sigmoid
    from differt2d_tpu_torch.ops import _build
    from differt2d_tpu_torch.ops import power_map_kernel as pmk
    from differt2d_tpu_torch.rt import path_candidate_matrices

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, nvcc_s = _build.build(pmk.SOURCE)
    pmk.load_library()
    print(f"build: {nvcc_s:.1f} s in nvcc, {time.perf_counter() - t0:.1f} s total -> {lib_path}",
          flush=True)
    for line in _build.BUILD_LOG.get(pmk.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  ptxas:", line.strip(), flush=True)

    # -- 3. main path at full size ------------------------------------------------
    n = 1024
    scene = Scene.basic_scene()
    X, Y = grid(n, dev)
    main_kw = dict(max_order=1, approx=True)
    pmk.reset_launches()
    Z = power_map(scene, X, Y, **main_kw)
    Zv, dZ = power_map(scene, X, Y, value_and_grad=True, **main_kw)
    torch.cuda.synchronize()
    launches = dict(pmk.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    check(launches["power_map_value"] >= 1, "power_map_value was not launched on the main path")
    check(launches["power_map_vag"] >= 1, "power_map_vag was not launched on the main path")
    check(Z.shape == (n, n) and dZ.shape == (n, n, 2), "main path: wrong output shapes")

    groups = path_candidate_matrices(scene.num_objects, 0, 1)
    inputs = pmk.kernel_inputs(groups, dev, approx=True, sigmoid=False)
    px, py = X.reshape(-1).contiguous(), Y.reshape(-1).contiguous()
    txs = torch.stack(list(scene.transmitters.values())).contiguous()
    scal = (100.0, 1e-2, 0.0, 0.5, 0.1)
    args = (px, py, txs, scene.walls, scene.kind, scene.phi, scal, inputs)
    ref_v = pmk.plain_value(*args)
    ref_vv, ref_g = pmk.plain_value_and_grad(*args)
    err_value = assert_close("value map 1024^2", Z.reshape(-1), ref_v)
    assert_close("vag value 1024^2", Zv.reshape(-1), ref_vv)
    err_vag = max(max_abs(Zv.reshape(-1), ref_vv), assert_kinks("vag gradient 1024^2", dZ.reshape(-1, 2), ref_g))
    check(float(Z.sum()) > 0.0, "main path: the map is all zero")
    print(f"main path ok: value err {err_value:.3g}, vag err {err_vag:.3g}", flush=True)

    # -- 4. coverage at 256^2 -----------------------------------------------------------
    m = 256
    Xs, Ys = grid(m, dev)
    mixed = Scene.square_scene().add_ris([[0.5, 0.3], [0.5, 0.7]]).add_vertex([0.25, 0.75])
    two_tx = scene.update_transmitters(tx2=[0.8, 0.8])
    cases = [
        ("hard logic", scene, dict(max_order=1, approx=False)),
        ("sigmoid", scene, dict(max_order=1, approx=True, function=sigmoid)),
        ("RIS + vertex", mixed, dict(max_order=1, approx=True)),
        ("two TX", two_tx, dict(max_order=1, approx=True)),
        ("TX grid", scene, dict(max_order=1, approx=True, on_transmitters=True)),
        ("order 2", scene, dict(max_order=2, approx=True)),
    ]
    for name, sc, kw in cases:
        before = dict(pmk.LAUNCHES)
        got = power_map(sc, Xs, Ys, **kw)
        check(pmk.LAUNCHES["power_map_value"] > before["power_map_value"],
              f"{name}: the value kernel did not run")
        # The plain version on the kernel's own inputs: a transmitter grid
        # runs as the receiver grid of the swapped scene (path reversal).
        rsc, rkw = sc, kw
        if kw.get("on_transmitters"):
            rsc, rkw = sc.swap_ends(), {**kw, "on_transmitters": False}
        ref = power_map(rsc, Xs, Ys, backend="torch", **rkw)
        assert_close(f"{name} value", got, ref)
        if kw["max_order"] <= 1:
            gv, gg = power_map(sc, Xs, Ys, value_and_grad=True, **kw)
            rv, rg = power_map(rsc, Xs, Ys, value_and_grad=True, backend="torch", **rkw)
            assert_close(f"{name} vag value", gv, rv)
            assert_kinks(f"{name} vag gradient", gg, rg)

    # -- 5. autograd through the kernel ---------------------------------------------
    def scene_grads(backend):
        walls = scene.walls.detach().clone().requires_grad_(True)
        tx = scene.transmitters["tx"].detach().clone().requires_grad_(True)
        alpha = torch.tensor(100.0, device=dev, requires_grad=True)
        sc = Scene.from_arrays(walls, scene.kind, scene.phi, {"tx": tx}, scene.receivers)
        out = power_map(sc, Xs, Ys, max_order=1, approx=True, alpha=alpha, backend=backend)
        return (out, *torch.autograd.grad(out.sum(), (walls, tx, alpha)))

    before = pmk.LAUNCHES["power_map_value"]
    got = scene_grads("auto")
    check(pmk.LAUNCHES["power_map_value"] > before, "autograd: the value kernel did not run")
    ref = scene_grads("torch")
    for name, a, b in zip(("value", "d/dwalls", "d/dtx", "d/dalpha"), got, ref):
        assert_close(f"autograd {name}", a, b)
    print("autograd through the kernel ok", flush=True)

    # -- 6. timing -----------------------------------------------------------------------------
    P = n * n
    k, reps = 32, 5
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(smi("clocks.max.sm").split()[0])
    peak_fp32 = props.multi_processor_count * 128 * 2 * max_mhz * 1e6
    print(f"peak fp32 {peak_fp32 / 1e12:.1f} TFLOP/s ({props.multi_processor_count} SMs x 128"
          f" x 2 x {max_mhz:.0f} MHz)", flush=True)

    def kernel_call(with_grad):
        fn = pmk.value_and_grad if with_grad else pmk.value
        return lambda: fn(*args, approx=True, sigmoid=False)

    e2e_ms = cuda_time_ms(lambda: power_map(scene, X, Y, **main_kw), k, reps)
    e2e_vag_ms = cuda_time_ms(lambda: power_map(scene, X, Y, value_and_grad=True, **main_kw), k, reps)
    rows = []
    for name, with_grad, err in (("power_map_value", False, err_value),
                                 ("power_map_vag", True, err_vag)):
        before = pmk.LAUNCHES[name]
        ms = cuda_time_ms(kernel_call(with_grad), k, reps)
        per_map = (pmk.LAUNCHES[name] - before) / (k * reps + 1)
        plain = pmk.plain_value_and_grad if with_grad else pmk.plain_value
        plain_ms = cuda_time_ms(lambda: plain(*args), 2, 3)
        bytes_moved = P * (8 + (12 if with_grad else 4))
        ops_px, ops_launch = ops_count(groups, scene.kinds, txs.shape[0], with_grad)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = (P * ops_px + ops_launch) / peak_fp32 * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"{name}: {ms:.4f} ms/map, {P / ms * 1e3:.4g} points/s, {per_map:g} launches/map;"
              f" plain {plain_ms:.3f} ms/map; bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of the"
              f" kernel's time ({ops_px} ops/px + {ops_launch} per launch, {bytes_moved / P:.0f}"
              f" B/px)", flush=True)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    print(f"end to end power_map 1024^2: value {e2e_ms:.4f} ms/map ({P / e2e_ms * 1e3:.4g}"
          f" points/s), value+grad {e2e_vag_ms:.4f} ms/map ({P / e2e_vag_ms * 1e3:.4g} points/s)",
          flush=True)
    print("library_ms: null -- no single PyTorch call computes this map", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
