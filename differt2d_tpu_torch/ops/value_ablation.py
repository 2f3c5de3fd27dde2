"""Ablation of the redesigned value kernel (``power_map_value``, B1) on a GPU.

Run from the root of a checkout, with one CUDA device:

    python3 -m differt2d_tpu_torch.ops.value_ablation

Each part of the redesign is taken out in turn, and the kernel without it
is timed against the kernel as shipped, in turns (on, off, off, on: CUDA
events, 32 maps chained, median of 5), on the main path's map (the basic
scene at 1024 x 1024, order <= 1, hard_sigmoid, alpha 100) and on the
24-wall slice of ``city_scene`` (stream proxy 1,176, the top of the value
route).  Every map without a part must equal the shipped one bit for bit.

* the rejection: the bounds ``(-inf, inf)``, so no test is skipped;
* the saturation exit: ``sat = inf``;
* the gate exit: a build of ``csrc/power_map.cu`` whose sweep is given no
  gate-exit bit;
* shared memory sized to W: a build whose launch reserves the dynamic
  shared memory of ``PM_MAX_WALLS`` walls, as the twin's static array does;
* every part at once.

Then each step of :data:`TRIALS`, tried on top of the shipped kernel and
timed the same way (shipped, trial, trial, shipped).  Every map is also
timed in sigmoid and hard logic (the basic scene).  The value kernels'
registers and spills come from each build's ``ptxas`` report.

The builds without a part, or with a trial, are copies of ``csrc/`` with a
line or two changed (:data:`EDITS`, :data:`TRIALS`), made under
``build/differt2d_tpu_torch/ablation/`` and compiled with the package's
flags; the shipped source has no switch.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys

import torch

from . import _build
from . import power_map_kernel as pmk
from .looped_tuning import cuda_time_ms

EDITS = {
    "gate exit": (("power_map.cu", "0xffffffffu, kGateExit}", "0xffffffffu, 0}"),),
    "shared memory sized to W": (("power_map.cu", "FAST ? fast_smem(W) : 0",
                                  "FAST ? fast_smem(PM_MAX_WALLS) : 0"),),
}
"""Per part taken out by a build: its edits ``(file, the shipped text, its
replacement)``; each shipped text occurs exactly once."""


def _min_blocks(n: int) -> tuple:
    return (("power_map.cu", "__launch_bounds__(PM_BLOCK)",
             f"__launch_bounds__(PM_BLOCK, G || !FAST ? 1 : {n})"),)


TRIALS = {
    "12 blocks of 128 per SM": _min_blocks(12),
    "10 blocks of 128 per SM": _min_blocks(10),
    "256 threads a block": (("power_map.cu", "#define PM_BLOCK 128", "#define PM_BLOCK 256"),),
}
"""Card-specific steps tried beyond the shared sweep, each as edits of the
shipped source: a least residency asked of the redesigned value kernel
(``__launch_bounds__``' second argument: the registers it may take fall
to fit it), or larger blocks.  A step is kept only where it gains in every
turn on every timed map (PERF.md says which)."""

VALUE_KERNELS = {f"power_map_kernelILb0ELi{soft}ELb1E": mode
                 for soft, mode in enumerate(("hard", "hard_sigmoid", "sigmoid"))}
"""Mangled name stems of the redesigned value kernels, by logic mode."""


def build_without(parts: tuple) -> tuple:
    """``(library, ptxas lines of the value kernels)``: ``csrc/power_map.cu``
    built with the edits of ``parts`` (names of :data:`EDITS` or
    :data:`TRIALS`), loaded and declared as the wrapper declares it."""
    tag = "-".join(sorted(p.split()[0] for p in parts)) or "shipped"
    src = os.path.join(_build.build_dir(), "ablation", tag)
    if os.path.isdir(src):
        shutil.rmtree(src)
    shutil.copytree(_build.CSRC_DIR, src)
    for name, old, new in (e for part in parts for e in {**EDITS, **TRIALS}[part]):
        path = os.path.join(src, name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            msg = f"{name}: {old!r} occurs {text.count(old)} times, not once"
            raise RuntimeError(msg)
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    out = os.path.join(src, "libpower_map.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(src, "power_map.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        msg = f"nvcc failed without {parts}:\n{proc.stdout}{proc.stderr}"
        raise RuntimeError(msg)
    lib = ctypes.CDLL(out)
    pmk._declare(lib)
    lines = (proc.stdout + proc.stderr).splitlines()
    report = []
    for i, line in enumerate(lines):
        for stem, mode in VALUE_KERNELS.items():
            if stem in line and "entry" in line:
                report.append(mode + ": " + ", ".join(
                    x.split(":")[-1].strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x))
    return lib, sorted(report)


def _map(lib, args, kkw, bounds):
    """One value map through ``lib``'s ``power_map_value`` with the
    rejection bounds and saturation margin ``bounds``."""
    launch = pmk._launch_args(*args, **kkw)
    host = [pmk._host_float(v) for v in args[6]]
    out = torch.empty_like(args[0])
    stream = torch.cuda.current_stream(args[0].device).cuda_stream
    pmk._check(lib.power_map_value(*launch, *bounds, *host, out.data_ptr(), stream),
               "power_map_value")
    return out


def requests(dev) -> list:
    """``(name, args, kernel kw)`` of the timed maps: the main path's and the
    24-wall city slice (hard_sigmoid), then the basic scene in sigmoid and
    in hard logic."""
    from .. import Scene
    from .. import tracer as tr
    from ..rt import path_candidate_matrices

    x = torch.linspace(0.01, 0.99, 1024, device=dev)
    y = torch.linspace(0.012, 0.988, 1024, device=dev)
    X, Y = torch.meshgrid(x, y, indexing="xy")
    city = Scene.city_scene(device=dev)
    scenes = (("basic scene", Scene.basic_scene(device=dev)),
              ("city slice, 24 walls", Scene.from_arrays(
                  city.walls[:24], transmitters=dict(city.transmitters),
                  receivers=dict(city.receivers), device=dev)))
    scenes += (("basic scene, sigmoid", scenes[0][1]), ("basic scene, hard logic", scenes[0][1]))
    out = []
    for name, sc in scenes:
        kkw = dict(approx=not name.endswith("hard logic"), sigmoid=name.endswith("sigmoid"))
        groups = path_candidate_matrices(sc.num_objects, 0, 1)
        inputs = pmk.kernel_inputs(groups, dev, **kkw)
        txs = torch.stack(list(sc.transmitters.values())).contiguous()
        scal = tuple(tr._OPTIONS[k] for k in tr._SCALAR_NAMES)
        args = (X.reshape(-1).contiguous(), Y.reshape(-1).contiguous(), txs, sc.walls, sc.kind,
                sc.phi, scal, inputs)
        out.append((name, args, kkw))
    return out


def main() -> int:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    builds = [(), *((p,) for p in EDITS), tuple(EDITS), *((t,) for t in TRIALS)]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(build_without, builds)))
    libs = {k: lib for k, (lib, _) in built.items()}
    for k, (_, report) in built.items():
        print(f"ptxas, value kernels, {' + '.join(k) or 'shipped'}: {'; '.join(report)}",
              flush=True)
    shipped = libs[()]
    inf = float("inf")
    for name, args, kkw in requests(dev):
        tlo, thi, sat = pmk._launch_bounds(args[0], kkw["approx"], kkw["sigmoid"], False,
                                           pmk._host_float(args[6][0]))
        on = (shipped, (tlo, thi, sat))
        parts = (
            ("rejection", (shipped, (-inf, inf, sat))),
            ("saturation exit", (shipped, (tlo, thi, inf))),
            *((p, (libs[(p,)], (tlo, thi, sat))) for p in EDITS),
            ("every part", (libs[tuple(EDITS)], (-inf, inf, inf))),
        )
        ref = _map(*on[:1], args, kkw, on[1])
        for part, other in (*parts, *(((t, (libs[(t,)], on[1])) for t in TRIALS))):
            trial = part in TRIALS
            got = _map(other[0], args, kkw, other[1])
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                msg = f"{name}: the map {'with' if trial else 'without'} {part} differs at" \
                      f" {int((got != ref).sum())} pixels"
                raise RuntimeError(msg)
            t = [cuda_time_ms(lambda lb=lb: _map(lb[0], args, kkw, lb[1]), 32, 5)
                 for lb in (on, other, other, on)]
            if trial:
                gains = max(t[1], t[2]) < min(t[0], t[3])
                print(f"{name}, with {part}: {(t[1] + t[2]) / 2:.4f} ms/map against"
                      f" {(t[0] + t[3]) / 2:.4f} as shipped (turns shipped, trial, trial,"
                      f" shipped: {', '.join(f'{x:.4f}' for x in t)}); the step gains in every"
                      f" turn: {gains} [{card}]", flush=True)
                continue
            gains = min(t[1], t[2]) > max(t[0], t[3])
            print(f"{name}, without {part}: {(t[1] + t[2]) / 2:.4f} ms/map against"
                  f" {(t[0] + t[3]) / 2:.4f} with it (turns on, off, off, on:"
                  f" {', '.join(f'{x:.4f}' for x in t)}); the part gains in every turn:"
                  f" {gains} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
