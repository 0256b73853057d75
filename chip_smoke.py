"""Drive ku_torch's main path on one NVIDIA GPU and check every step.

Usage, from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: CUDA must be present; print the card's name and power limit.
2. Build: compile the CD kernel from ku_torch/csrc with nvcc.
3. Kernel against its plain version on the card, same inputs:
   - saturated biases (every draw certain), Bernoulli, k = 1 and 2, ragged
     last batch, 2 epochs: params and scores rtol 1e-5 / atol 1e-5;
   - random parameters, all three modes, shared Philox draws, V = 784,
     H = 128, B = 128, 3 steps: params rtol 1e-5 / atol 1e-5, scores
     rtol 1e-4 / atol 1e-4 (float32 sums in another order; a few steps, so
     that no Bernoulli threshold moves by an ulp).
4. Main path: RBM({"lr": 1e-3, "batch_size": 128, "epochs": 3}, 128).fit on
   bench.py's synthetic MNIST-like data (N = 60,032, V = 784, p = 0.13);
   then the DBN 784 → 256 → 128, one epoch a layer, and its transform. The
   kernel's launch count must rise, every score be finite, and the
   reconstruction error fall.
5. Timing with CUDA events after warm-up: samples/s of RBM.fit, and the
   kernel, its plain version and the bound at the main path's shape.

The last lines are the `kernels` JSON line, the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ku_torch.ebm import DBN, RBM
from ku_torch.kernels import cd_gibbs

N, V_DIM, H_DIM, BATCH, EPOCHS, K = 60032, 784, 128, 128, 3, 1
LR = 1e-3
DEVICE = "cuda"

# Published peaks (NVIDIA data sheets, dense): f32 outside the tensor cores
# in FLOP/s, and memory bandwidth in bytes/s, by the name nvidia-smi reports.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H100": (67e12, 3.35e12),  # SXM
    "H200": (67e12, 4.8e12),
}


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def peaks(name: str):
    for key, value in PEAKS.items():
        if key in name:
            return value
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def timed_ms(fn, reps: int) -> float:
    """Mean ms per call of fn over reps calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mnist_like(seed=0) -> np.ndarray:
    """bench.py's data: MNIST-like sparse binary visibles."""
    rng = np.random.default_rng(seed)
    return (rng.random((N, V_DIM)) < 0.13).astype(np.float32)


def problem(dev, v_dim, h_dim, batch, steps, mode, saturated, seed):
    rng = np.random.default_rng(seed)
    if saturated:
        w = np.zeros((v_dim, h_dim))
        bh = np.where(np.arange(h_dim) % 2 == 0, 200.0, -200.0)
        bv = np.where(np.arange(v_dim) % 3 == 0, 200.0, -200.0)
    else:
        w = rng.uniform(-0.05, 0.05, (v_dim, h_dim))
        bh = rng.uniform(-0.05, 0.05, h_dim)
        bv = rng.uniform(-0.05, 0.05, v_dim)
    rows = batch * steps
    n = rows - 37 if saturated else rows
    if mode == cd_gibbs.MODE_VISIBLE_BERNOULLI:
        data = (rng.random((rows, v_dim)) < 0.13).astype(np.float32)
    else:
        data = rng.normal(size=(rows, v_dim)).astype(np.float32)
    data[n:] = 0.0
    mask = (np.arange(rows) < n).astype(np.float32)
    params = {name: torch.tensor(x, dtype=torch.float32, device=dev)
              for name, x in zip(("rbm_weight", "hidden_bias", "visible_bias"),
                                 (w, bh, bv))}
    return params, torch.from_numpy(data).to(dev), torch.from_numpy(mask).to(dev)


def check_against_plain(dev) -> float:
    """Phase 3; returns the largest abs difference seen."""
    worst = 0.0
    # (V, H, mode, k, saturated, steps, epochs): the RBM's shape, then the
    # DBN's two layers.
    cases = [(V_DIM, H_DIM, 0, k, True, 4, 2) for k in (1, 2)]
    cases += [(V_DIM, H_DIM, mode, 1, False, 3, 1) for mode in (0, 1, 2)]
    cases += [(V_DIM, 256, 0, 1, False, 2, 1), (256, H_DIM, 0, 1, False, 2, 1)]
    for v_dim, h_dim, mode, k, saturated, steps, epochs in cases:
        params, v_all, mask = problem(dev, v_dim, h_dim, BATCH, steps, mode,
                                      saturated, seed=10 + mode)
        args = (params, v_all, mask, 4321, LR, k, mode, BATCH, epochs)
        p_k, s_k = cd_gibbs.cd_train_cuda(*args)
        torch.cuda.synchronize()
        p_p, s_p = cd_gibbs.cd_train_torch(*args)
        torch.cuda.synchronize()
        s_tol = (1e-5, 1e-5) if saturated else (1e-4, 1e-4)
        for name in p_k:
            torch.testing.assert_close(p_k[name], p_p[name], rtol=1e-5, atol=1e-5,
                                       msg=f"{name}, mode {mode}, k {k}")
        torch.testing.assert_close(s_k, s_p, rtol=s_tol[0], atol=s_tol[1],
                                   msg=f"scores, mode {mode}, k {k}")
        p_diff = max(float((p_k[n] - p_p[n]).abs().max()) for n in p_k)
        s_diff = float((s_k - s_p).abs().max())
        worst = max(worst, p_diff, s_diff)
        log(f"kernel vs plain: {v_dim}x{h_dim} mode {mode} k {k} saturated "
            f"{saturated} steps {steps * epochs}: max abs diff params "
            f"{p_diff:.3e}, scores {s_diff:.3e} (largest score "
            f"{float(s_p.abs().max()):.3e})")
    return worst


def recon_error(rbm, x) -> float:
    g = torch.Generator(device=x.device).manual_seed(0)
    return float((rbm.inv_transform(rbm.transform(x, g), g) - x).abs().mean())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. Build.
    t0 = time.perf_counter()
    lib, report = cd_gibbs.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  {line.strip()}")
    log(f"cooperative grid at {V_DIM}x{H_DIM}, batch {BATCH}: "
        f"{cd_gibbs.grid_size(BATCH, V_DIM, H_DIM)} blocks")

    # 3. Kernel against its plain version.
    max_abs_err = check_against_plain(dev)

    # 4. Main path: RBM.fit, then the DBN, counting kernel launches.
    V = torch.from_numpy(mnist_like()).to(dev)
    probe = V[:4096]
    cd_gibbs.cd_train_cuda.launches = 0
    rbm = RBM({"lr": LR, "batch_size": BATCH, "epochs": EPOCHS}, H_DIM,
              input_dim=V_DIM, seed=0, device=dev)
    err_before = recon_error(rbm, probe)
    rbm.fit(V)
    torch.cuda.synchronize()
    err_after = recon_error(rbm, probe)
    scores = rbm.last_scores
    check(scores.shape == (EPOCHS * N // BATCH,), f"scores shape {scores.shape}")
    check(bool(torch.isfinite(scores).all()), "non-finite score")
    for p in rbm.params.values():
        check(bool(torch.isfinite(p).all()), "non-finite parameter")
    check(err_after < err_before,
          f"reconstruction error did not fall: {err_before} -> {err_after}")
    log(f"RBM.fit: reconstruction error {err_before:.4f} -> {err_after:.4f}, "
        f"score first/last epoch {float(scores[:N // BATCH].mean()):.4f} / "
        f"{float(scores[-(N // BATCH):].mean()):.4f}")

    dbn = DBN()
    dbn.add_stack(RBM({"lr": LR, "batch_size": BATCH, "epochs": 1}, 256, seed=1,
                      device=dev))
    dbn.add_stack(RBM({"lr": LR, "batch_size": BATCH, "epochs": 1}, 128, seed=2,
                      device=dev))
    dbn.fit(V)
    h = dbn.transform(V)
    torch.cuda.synchronize()
    check(h.shape == (N, 128), f"DBN transform shape {h.shape}")
    check(bool(((h == 0) | (h == 1)).all()), "DBN transform is not binary")
    for layer in dbn.rbm_layers:
        check(bool(torch.isfinite(layer.last_scores).all()), "non-finite DBN score")
    launches = cd_gibbs.cd_train_cuda.launches
    check(launches == 3,
          f"expected 3 kernel launches (RBM + 2 DBN layers), got {launches}")
    check(dbn.inv_transform(h).shape == (N, V_DIM), "DBN inv_transform shape")
    log(f"DBN 784-256-128: transform {tuple(h.shape)}, mean activation "
        f"{float(h.mean()):.4f}; kernel launches on the main path: {launches}")

    # 5. Timing, after the warm-up above.
    fit_ms = timed_ms(lambda: RBM({"lr": LR, "batch_size": BATCH, "epochs": EPOCHS},
                                  H_DIM, input_dim=V_DIM, seed=3, device=dev
                                  ).fit(V, verbose=0), 2)
    samples_per_s = N * EPOCHS / (fit_ms / 1e3)
    log(f"RBM.fit {EPOCHS} epochs: {fit_ms:.3f} ms, {samples_per_s:.1f} samples/s")

    params = {n: t.contiguous() for n, t in rbm.params.items()}
    mask = torch.ones(N, device=dev)
    run = (params, V, mask, 99, LR, K, 0, BATCH, EPOCHS)
    launches_before = cd_gibbs.cd_train_cuda.launches
    kernel_ms = timed_ms(lambda: cd_gibbs.cd_train_cuda(*run), 3)
    plain_ms = timed_ms(lambda: cd_gibbs.cd_train_torch(*run), 1)
    check(cd_gibbs.cd_train_cuda.launches == launches_before + 3, "timed launches")

    steps = EPOCHS * N // BATCH
    flops = (2 * K + 3) * 2 * BATCH * V_DIM * H_DIM * steps
    nbytes = 4 * (N * V_DIM + N + 2 * (V_DIM * H_DIM + V_DIM + H_DIM) + steps)
    peak_flops, peak_bw = peaks(name)
    bound_flops_ms, bound_bytes_ms = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    bound_ms = max(bound_flops_ms, bound_bytes_ms)
    log(f"cd_gibbs at {N}x{V_DIM}x{H_DIM}, batch {BATCH}, {EPOCHS} epochs: "
        f"kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s achieved")

    kernels = [{
        "name": "cd_gibbs",
        "route": "cuda",
        "source": "ku_torch/csrc/cd_gibbs.cu",
        "replaces": "ku/pallas/cd_gibbs.py:90",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_flops_ms >= bound_bytes_ms else "bytes",
        # No single PyTorch call computes a CD-k training run.
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
