"""Op-throughput probe of the card: CUDA kernel K6 and its report.

Port of ``scripts/microbench_vpu.py``.  The same method, re-expressed for
SIMT (``csrc/opchain.cu``): each thread holds a rotation pair (a, b) in
registers and runs ``rounds`` rounds of one body; each body is timed with
CUDA events at two depths R and 3R and its cost is the slope, so the launch
and the one read and write of the pair cancel; the costs of select, exp and
the three data movements are their slopes minus the bare rotation's, in
units of the ``mul`` slope (one issue slot per element), less the
instructions known to ride along (``KNOWN_EXTRA``).

    python -m cilqr_tpu_torch.utils.opbench      # prints the JSON report

The report names the card; it is written nowhere.  ``opchain`` launches the
kernel for CUDA tensors and takes the plain PyTorch version
(``opchain_plain``, the same rounds as elementwise ops, with
``torch.gather`` / ``torch.roll`` / a transpose for the data movements) for
CPU tensors.
"""

from __future__ import annotations

import json
import math

import torch

from cilqr_tpu_torch.ops import riccati_cuda
from cilqr_tpu_torch.utils.device import resolve

LAUNCHES = 0  # kernel launches made by this module's wrapper

BODIES = ("mul", "fma", "rot", "sel", "exp", "gather", "roll", "tpose")
# Instructions per round beyond the rotation that are not the op being
# measured: exp: the scaling multiply and the final multiply-add; gather:
# convert, and, multiply-add; roll, tpose: the multiply-add (the index
# arithmetic of a roll and the barriers of a transpose count as its cost).
KNOWN_EXTRA = {"sel": 0.0, "exp": 2.0, "gather": 3.0, "roll": 1.0, "tpose": 1.0}
THREADS = 256   # block size of the kernel; n must be a multiple
WARP = 32
TILE = 16       # the transpose body's tile: TILE * TILE == THREADS
COS, SIN = math.cos(0.7), math.sin(0.7)
PEAK_FP32_FLOPS = 67e12  # published float32 peak of one H100 SXM, outside the tensor cores
R0 = 1024       # the report's depths are R0 and 3 R0 rounds
WAVES = 4       # the report's grid: this many full waves of resident threads
TIMED_LAUNCHES = 5  # launches per timing; the least of REPEATS timings is kept
REPEATS = 3


def sel_threshold(r: int) -> float:
    """The select body's threshold on b in round r."""
    return 0.01 * r - 2.5


def opchain_plain(body: str, rounds: int, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``rounds`` rounds of ``body`` on the
    pairs (x[0], x[1]), x (2, n) with n a multiple of 256.  Lanes are the
    consecutive groups of 32 elements, transpose tiles the consecutive
    groups of 256 seen as (16, 16)."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    a, b = x[0].clone(), x[1].clone()
    for r in range(rounds):
        if body == "mul":
            a = a * 1.0000001
            continue
        if body == "fma":
            a = a * 0.9999999 + 1e-7
            continue
        a, b = a * COS - b * SIN, a * SIN + b * COS
        if body == "sel":
            a = torch.where(b > sel_threshold(r), a, -a)
        elif body == "exp":
            a = a + torch.exp(b * 1e-3) * 1e-6
        elif body == "gather":
            lanes = b.view(-1, WARP)
            src = (lanes.to(torch.int32) & (WARP - 1)).long()
            a = a + torch.gather(lanes, 1, src).reshape(-1) * 1e-6
        elif body == "roll":
            amt = (r + 1) & (WARP - 1)
            a = a + torch.roll(b.view(-1, WARP), amt, dims=1).reshape(-1) * 1e-6
        elif body == "tpose":
            a = a + b.view(-1, TILE, TILE).transpose(1, 2).reshape(-1) * 1e-6
    return torch.stack([a, b])


def sel_margin(rounds: int, x: torch.Tensor) -> torch.Tensor:
    """Per element, the least distance of b from the select body's threshold
    over the rounds, along the float64 chain.  An element whose margin is
    within float32 rounding of 0 may take the other branch in another
    float32 implementation, and from there on differs in sign."""
    a, b = x[0].double(), x[1].double()
    margin = torch.full_like(a, math.inf)
    for r in range(rounds):
        a, b = a * COS - b * SIN, a * SIN + b * COS
        margin = torch.minimum(margin, (b - sel_threshold(r)).abs())
        a = torch.where(b > sel_threshold(r), a, -a)
    return margin


def _launch(body: str, rounds: int, x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    from cilqr_tpu_torch.utils import build

    n = x.shape[1]
    riccati_cuda.check_cuda_f32("x", x, (2, n))
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):  # the card of the tensors, whichever is current
        rc = lib.cilqr_opchain(BODIES.index(body), rounds, n, x.data_ptr(), out.data_ptr(), stream)
    build.check(lib, rc, "op-chain kernel launch")
    LAUNCHES += 1
    return out


def opchain(body: str, rounds: int, x: torch.Tensor) -> torch.Tensor:
    """``rounds`` rounds of ``body`` on x (2, n) float32, n a multiple of
    256: the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")
    if x.ndim != 2 or x.shape[0] != 2 or x.shape[1] % THREADS or rounds < 0:
        raise ValueError(f"x must be (2, n) with n a multiple of {THREADS} and rounds >= 0, "
                         f"got {tuple(x.shape)}, rounds={rounds}")
    if x.device.type == "cpu":
        return opchain_plain(body, rounds, x)
    return _launch(body, rounds, x)


def probe_input(n: int, seed: int = 0, device=None) -> torch.Tensor:
    """(2, n) float32 uniform in [-2, 2) from a seeded generator, on the
    card unless ``device`` says otherwise."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((2, n), generator=g, dtype=torch.float32) * 4.0 - 2.0).to(resolve(device))


def _time_ms(body: str, rounds: int, x: torch.Tensor) -> float:
    """Least mean milliseconds per launch over REPEATS runs of TIMED_LAUNCHES
    launches (CUDA events), after a warm-up launch."""
    opchain(body, rounds, x)
    best = math.inf
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMED_LAUNCHES):
            opchain(body, rounds, x)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / TIMED_LAUNCHES)
    return best


def measure() -> dict:
    """Time every body at depths R0 and 3 R0 on the current CUDA device and
    derive the op rates.  The grid is WAVES full waves of the card: SM
    count x 2048 resident threads x WAVES elements, in blocks of 256."""
    if not torch.cuda.is_available():
        raise RuntimeError("opbench.measure needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    props = torch.cuda.get_device_properties(dev)
    n = props.multi_processor_count * 2048 * WAVES
    x = probe_input(n, 0, dev)
    r0, r1 = R0, 3 * R0
    report = {"device": torch.cuda.get_device_name(dev), "sm_count": props.multi_processor_count,
              "grid": {"blocks": n // THREADS, "threads_per_block": THREADS, "elements": n,
                       "resident_warps_per_sm_at_full_occupancy": 2048 // WARP},
              "rounds": [r0, r1], "launches_per_timing": TIMED_LAUNCHES, "repeats": REPEATS,
              "kernels": {}}
    slope = {}
    for body in BODIES:
        t0 = _time_ms(body, r0, x)
        t1 = _time_ms(body, r1, x)
        slope[body] = max(t1 - t0, 1e-9) * 1e-3 / (r1 - r0)  # s per round per launch
        report["kernels"][body] = {"t_r0_us": t0 * 1e3, "t_r1_us": t1 * 1e3,
                                   "per_round_ps_per_elem": slope[body] / n * 1e12}
    slot_s = slope["mul"] / n  # s per one-instruction op per element

    def extra(body):
        return (slope[body] - slope["rot"]) / n / slot_s - KNOWN_EXTRA[body]

    fma_flops = 2.0 * n / slope["fma"]
    report["constants"] = {
        "mul_ops_per_s": 1.0 / slot_s,
        "fma_flops_per_s": fma_flops,
        "fma_share_of_published_fp32_peak": fma_flops / PEAK_FP32_FLOPS,
        "published_fp32_peak_flops": PEAK_FP32_FLOPS,
        "fma_vs_mul": slope["fma"] / slope["mul"],
        "rot_slots_check": slope["rot"] / n / slot_s,
        "cmp_select_slots": extra("sel"),
        "exp_slots": extra("exp"),
        "shuffle_gather_slots": extra("gather"),
        "shuffle_roll_slots": extra("roll"),
        "smem_transpose_slots": extra("tpose"),
        "known_extra_slots": KNOWN_EXTRA,
    }
    return report


def main() -> int:
    print(json.dumps(measure(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
