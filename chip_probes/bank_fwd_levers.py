#!/usr/bin/env python3
"""Tuning levers of the tensor-core bank InfoNCE forward, on one NVIDIA GPU.

    python3 chip_probes/bank_fwd_levers.py

Builds `bank_fwd_levers.cu` four times (nvcc, sm_90a, beside the package's
kernels in build/kernels/): `varbase` (the package's design through the
variant code, the control), `stages4` (a fourth ring stage over bf16 and
int8 banks), `presplit` (Q split into TF32 hi / lo once per launch, bf16
and int8) and `chunksplit` (the A tile split once per chunk in shared
memory). At B=256, M=65,536 (D=640 and 512 over float32, bf16 and int8
banks, D=768 float32) and blip's B=128, D=256 float32 it checks that each
variant's statistics, loss and dtau equal the package kernel's bit for bit
and reads each one's device time of 20 back-to-back launches
(`chip_smoke.device_ms`) in turns, package, variants, variants reversed,
package. Prints one line per case and a JSON summary (mean ms of the two
turns); exits non-zero where no GPU is found.
"""

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spn4cir_tpu_torch.ops import bank_kernels as bk  # noqa: E402
from spn4cir_tpu_torch.ops import cuda_build  # noqa: E402

# name: (VAR_STAGES, VAR_MODE)
VARIANTS = {"varbase": (3, 0), "stages4": (4, 0), "presplit": (3, 1),
            "chunksplit": (3, 2)}
CASES = ((256, 640, ("float32", "bfloat16", "int8")),
         (256, 512, ("float32", "bfloat16", "int8")),
         (256, 768, ("float32",)), (128, 256, ("float32",)))


def build(name, stages, mode):
    src = os.path.join(REPO, "chip_probes", "bank_fwd_levers.cu")
    out = cuda_build.BUILD_DIR / f"bank_fwd_levers-{name}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
           f"-DVAR_STAGES={stages}", f"-DVAR_MODE={mode}",
           "-I", str(cuda_build.CSRC_DIR), "-o", str(out), src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-3000:]}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "fwd_var_kernel" in line and "Compiling entry" in line:
            # then "Function properties", the spill line, the register line
            print(f"{name} ptxas {line.split('fwd_var_kernel')[1][:12]}: "
                  f"{lines[i + 2].strip()} | {lines[i + 3].strip()}")
    return out


def variant_library(path):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    lib.bank_infonce_fwd_var.restype = i32
    lib.bank_infonce_fwd_var.argtypes = [ptr] * 3 + [f32] + [i32] * 7 + [ptr] * 7
    lib.bank_infonce_q8_fwd_var.restype = i32
    lib.bank_infonce_q8_fwd_var.argtypes = ([ptr] * 4 + [f32] + [i32] * 6
                                            + [ptr] * 7)
    print(f"{path.name}: dynamic shared memory {[lib.var_smem(c) for c in range(3)]}"
          f" bytes (float32, bf16, int8)")
    return types.SimpleNamespace(
        bank_infonce_fwd=lib.bank_infonce_fwd_var,
        bank_infonce_q8_fwd=lib.bank_infonce_q8_fwd_var)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bank_fwd_levers: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    package = bk._library()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {n: pool.submit(build, n, *v) for n, v in VARIANTS.items()}
        libs = {"package": package}
        libs.update({n: variant_library(f.result()) for n, f in futs.items()})
    order = list(libs)
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(2)
    results = {}
    try:
        for b, d, kinds in CASES:
            m = 65536
            q = cs.unit_rows(b, d, g, dev)
            bank32 = cs.unit_rows(m, d, g, dev)
            labels = torch.randint(0, m, (b,), generator=g, device=dev)
            for kind in kinds:
                bank = (bk.quantize_bank(bank32) if kind == "int8"
                        else bank32.to(getattr(torch, kind)))
                fwd = (bk.bank_infonce_q8_fwd if kind == "int8"
                       else bk.bank_infonce_fwd)
                outs, times = {}, {n: [] for n in order}
                for n in order:
                    bk._library = lambda lib=libs[n]: lib
                    loss, stats, dtau = fwd(q, bank, labels, cs.TAU)
                    outs[n] = torch.cat([torch.stack(stats).flatten(),
                                         loss[None], dtau[None]])
                for n in order + order[::-1]:
                    bk._library = lambda lib=libs[n]: lib
                    times[n].append(cs.device_ms(
                        lambda: fwd(q, bank, labels, cs.TAU), n=20))
                same = all(torch.equal(outs[n], outs["package"]) for n in order)
                assert same, f"a variant's statistics differ at {b}, {d}, {kind}"
                key = f"B={b}, M={m}, D={d} {kind}"
                results[key] = {n: sum(v) / 2 for n, v in times.items()}
                print(f"{key}: every variant bit-identical to the package; "
                      f"device ms back to back, two turns each: "
                      f"{ {n: [round(x, 4) for x in v] for n, v in times.items()} }"
                      f" [{card}]", flush=True)
    finally:
        bk._library = lambda: package
    print(json.dumps({"card": card, "device_ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
