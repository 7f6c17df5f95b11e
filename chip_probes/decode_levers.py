#!/usr/bin/env python3
"""Levers of the decode-step kernels #11 (decode attention) and #12 (int8
weight matmul), on one NVIDIA GPU.

    python3 chip_probes/decode_levers.py [<parent checkout>]

Builds, beside the package's kernels in build/kernels/levers/, variants of
`csrc/decode_attention.cu` and `csrc/quant_matmul.cu`, each made by
replacing lines of the package's source (every replacement must match):

  #12 `copy`     the products skipped: the cp.async ring alone;
      `compute`  the copies skipped: the arithmetic alone;
      `lop3x2`   the int8 widening's masks written in C, which the compiler
                 emits as two LOP3 each (the package: one);
  #11 `copy`     the softmax and the V product skipped: the ring alone;
      `tile4k`   twice the rows a tile: 4 KB over bf16 and int8 (4 and 8
                 rows a lane group; the package: 2 KB, 2 and 4), 8 KB over
                 float32;
      `stages2`, `stages4`  a ring of two or four tiles (the package: 3);

and, given a parent checkout (a `git archive` of the parent commit,
unpacked), the parent's two sources with their own C interfaces and
plans. It reads the device time of back-to-back launches
(`chip_smoke.device_ms`) at the 7B's decode shapes, package, variants,
variants reversed, package:

  #12 at (4096, 4096), (4096, 11008), (11008, 4096) and (4096, 32000) with
      1 and 16 rows of float32 x and 16 rows of bf16 x, beside bf16 cuBLAS
      on a dense bf16 copy of the weight; then the package over every split
      count whose clusters fit on the card and the first that does not;
  #11 over bf16 caches at B = 16, 8, 1 over L = 1,842 and B = 16 over L =
      1,241, beside SDPA at query length 1, and over int8 and float32
      caches at B = 16; then B = 1 at 4, 5 and 8 splits.

The variants that compute the same function (`lop3x2`, `tile4k`,
`stages*`, the parent) are held against the package's output (bit for bit
where the order of the sums is the same, else within the smoke's
tolerance). Prints one line per case; exits non-zero where no GPU is
found.
"""

import concurrent.futures
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spn4cir_tpu_torch.ops import cuda_build  # noqa: E402
from spn4cir_tpu_torch.ops import decode_attn as da  # noqa: E402
from spn4cir_tpu_torch.ops import quant_matmul as qm  # noqa: E402

QMM, DEC = "quant_matmul.cu", "decode_attention.cu"
VARIANTS = {
    "qmm_copy": (QMM, [("for (int kk2 = 0; kk2 < kSteps; ++kk2) {",
                        "for (int kk2 = 0; kk2 < 0; ++kk2) {")]),
    "qmm_compute": (QMM, [
        ("    if (st >= n_k) return;\n    uint8_t* dst = w_ring",
         "    if (st >= 0) return;\n    uint8_t* dst = w_ring"),
        ("    if (st >= n_k || tid >= kXChunks) return;",
         "    if (st >= 0) return;")]),
    "qmm_lop3x2": (QMM, [
        ("const uint32_t mag = and_or(t, 0x007f007fu, 0x43004300u);",
         "const uint32_t mag = (t & 0x007f007fu) | 0x43004300u;"),
        ("const uint32_t off = and_or(t, 0x00800080u, 0xc300c300u);",
         "const uint32_t off = (t & 0x00800080u) | 0xc300c300u;")]),
    "dec_copy": (DEC, [("    issue(i + kStages - 1);\n",
                        "    issue(i + kStages - 1);\n"
                        "    if (mine > 0) continue;\n")]),
    "dec_tile4k": (DEC, [("  return sizeof(T) == 1 ? 4 : 2;",
                          "  return sizeof(T) == 1 ? 8 : 4;")]),
    "dec_stages2": (DEC, [("constexpr int kStages = 3; ",
                           "constexpr int kStages = 2; ")]),
    "dec_stages4": (DEC, [("constexpr int kStages = 3; ",
                           "constexpr int kStages = 4; ")]),
}
SAME_FUNCTION = ("qmm_lop3x2", "dec_tile4k", "dec_stages2", "dec_stages4")
QMM_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
DEC_ARGS = [PTR, I32, PTR, PTR, I32, I64, I64, PTR, I64, PTR, PTR, I64]


def cdiv(a, b):
    return -(-a // b)


def build_all(parent):
    """name -> loaded library: the variants and, given, the parent's two."""
    out_dir = cuda_build.BUILD_DIR / "levers"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, (src, subs) in VARIANTS.items():
        text = (cuda_build.CSRC_DIR / src).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} matches "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        sources[name] = (path, cuda_build.CSRC_DIR)
    if parent:
        csrc = os.path.join(parent, "spn4cir_tpu_torch", "csrc")
        sources["qmm_parent"] = (os.path.join(csrc, QMM), csrc)
        sources["dec_parent"] = (os.path.join(csrc, DEC), csrc)

    def one(name):
        src, inc = sources[name]
        lib = out_dir / f"{name}.so"
        proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                               "-I", str(inc), "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n"
                               f"{proc.stderr[-3000:]}")
        return name, ctypes.CDLL(str(lib))

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(pool.map(one, sources))
    for name, lib in libs.items():
        if name.startswith("qmm"):
            lib.quant_matmul.argtypes = ([PTR, I32, PTR, PTR] + [I32] * 6
                                         + [PTR] * (3 if name == "qmm_parent"
                                                    else 2))
        else:
            lib.decode_attention.argtypes = (
                DEC_ARGS + [I32] * 7 + [ctypes.c_float]
                + [PTR] * (3 if name == "dec_parent" else 2))
    return libs


def parent_qmm_plan(rows, d, f, sm):
    """The parent's plan: row tiles of 1-8, D in chunks of 128."""
    rt = 1
    while rt < min(rows, 8):
        rt *= 2
    tiles = cdiv(rows, rt) * cdiv(f, 256)
    n = max(1, min(cdiv(2 * sm, tiles), d // 256))
    if n == 1:
        return rt, d, 1
    per = cdiv(cdiv(d, n), 128) * 128
    return rt, per, cdiv(d, per)


def in_turns(fns):
    """Each (name, fn) timed in the order given and again reversed; the
    mean of its two readings."""
    got = {}
    for name, fn in list(fns) + list(reversed(fns)):
        got.setdefault(name, []).append(cs.device_ms(fn, n=30))
    return {k: sum(v) / len(v) for k, v in got.items()}


def probe_qmm(libs, device, sm, stream):
    g = torch.Generator(device=device).manual_seed(0)
    for d, f in QMM_SHAPES:
        w = torch.randint(-127, 128, (d, f), generator=g,
                          device=device).to(torch.int8)
        s = torch.rand(f, generator=g, device=device) * 1e-3 + 1e-4
        wb = (w.float() * s).to(torch.bfloat16)
        for rows, dtype in ((1, torch.float32), (16, torch.float32),
                            (16, torch.bfloat16)):
            code = qm._X_CODES[dtype]
            x = torch.randn(rows, d, generator=g, device=device).to(dtype)
            clusters = qm.device_plan_inputs(device.index or 0, code,
                                             qm.n_tiles_for(rows))
            nt, per, n = qm.split_plan(rows, d, f, clusters)
            outs = {}

            def ours(lib, per=per, n=n, key=None):
                y = torch.empty(rows, f, device=device, dtype=dtype)

                def run():
                    err = lib.quant_matmul(x.data_ptr(), code, w.data_ptr(),
                                           s.data_ptr(), rows, d, f, nt, per,
                                           n, y.data_ptr(), stream())
                    assert err == 0, err
                if key:
                    outs[key] = y
                return run

            fns = [("package", lambda: qm.quant_matmul(x, w, s))]
            fns += [(k, ours(libs[k], key=k)) for k in libs
                    if k.startswith("qmm_") and k != "qmm_parent"]
            if "qmm_parent" in libs:
                rt, pper, pn = parent_qmm_plan(rows, d, f, sm)
                part = torch.empty(pn, rows, f, device=device)
                yp = torch.empty(rows, f, device=device, dtype=dtype)
                outs["qmm_parent"] = yp
                fns.append(("qmm_parent", lambda: libs["qmm_parent"]
                            .quant_matmul(x.data_ptr(), code, w.data_ptr(),
                                          s.data_ptr(), rows, d, f, rt, pper,
                                          pn, yp.data_ptr(), part.data_ptr(),
                                          stream())))
            xb = x.to(torch.bfloat16)
            fns.append(("cublas_bf16", lambda: xb @ wb))
            for _, fn in fns:
                fn()
            torch.cuda.synchronize()
            want = qm.quant_matmul(x, w, s)
            for k, y in outs.items():
                if k in SAME_FUNCTION:
                    assert torch.equal(y, want), k
                elif k == "qmm_parent":
                    tol = cs.QMM_TOL[dtype]
                    scale = want.float().abs().max().item()
                    torch.testing.assert_close(y.float(), want.float(),
                                               rtol=tol, atol=tol * scale)
            times = in_turns(fns)
            sweep = []
            for m in range(1, qm.MAX_SPLITS + 1):
                if m > 1 and cdiv(rows, 8 * nt) * cdiv(f, qm.COLS) > \
                        clusters[m - 1]:
                    sweep.append(m)
                    break
                sweep.append(m)
            spl = []
            for m in sweep:
                mper = cdiv(cdiv(d, qm.DEPTH), m) * qm.DEPTH
                mn = cdiv(d, mper)
                run = ours(qm._library(), mper, mn)
                spl.append(f"{mn}: {cs.device_ms(run, n=30):.4f}")
            print(f"#12 ({d}, {f}) rows={rows} x {cs.dtype_name(dtype)}, "
                  f"{n} splits: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in times.items())
                  + f" | package by split count {', '.join(spl)} "
                  f"(clusters that fit: {clusters[:len(sweep)]})",
                  flush=True)
        del w, wb
        torch.cuda.empty_cache()


def probe_dec(libs, device, sm, stream):
    g = torch.Generator(device=device).manual_seed(1)
    cases = ((16, 1842, "bfloat16"), (8, 1842, "bfloat16"),
             (1, 1842, "bfloat16"), (16, 1241, "bfloat16"),
             (16, 1842, "int8"), (16, 1842, "float32"))
    for b, length, kind in cases:
        q, k, v, bias, ks, vs = cs.decode_inputs(b, 32, 128, length, 2, 1,
                                                 kind, g, device)
        code = da._CACHE_CODES[k.dtype]
        kl, vl = k[1], v[1]
        ksl = ks[1] if ks is not None else None
        vsl = vs[1] if vs is not None else None
        args = (q.data_ptr(), 0, kl.data_ptr(), vl.data_ptr(), code,
                kl.stride(0), kl.stride(1), bias.data_ptr(), bias.stride(0),
                None if ksl is None else ksl.data_ptr(),
                None if vsl is None else vsl.data_ptr(),
                0 if ksl is None else ksl.stride(0), b, 32, 32, 128, length)
        rows, n = da.split_plan(length, b * 32, sm)
        out_dtype = torch.float32 if kind == "int8" else k.dtype
        outs = {}

        def ours(lib, rows=rows, n=n, key=None):
            out = torch.empty(b, 32, 128, device=device, dtype=out_dtype)
            if key:
                outs[key] = out

            def run():
                err = lib.decode_attention(*args, rows, n, 128 ** -0.5,
                                           out.data_ptr(), stream())
                assert err == 0, err
            return run

        fns = [("package", lambda: da.decode_attention(q, k, v, 1, bias, ks,
                                                        vs))]
        fns += [(key, ours(libs[key], key=key)) for key in libs
                if key.startswith("dec_") and key != "dec_parent"]
        if "dec_parent" in libs:
            want = max(1, cdiv(2 * sm, b * 32))
            pn = max(1, min(want, cdiv(length, 64)))
            prow = cdiv(length, pn)
            pn = cdiv(length, prow)
            part = torch.empty(b, 32, pn, 130, device=device)
            outp = torch.empty(b, 32, 128, device=device, dtype=out_dtype)
            outs["dec_parent"] = outp
            fns.append(("dec_parent", lambda: libs["dec_parent"]
                        .decode_attention(*args, prow, pn, 128 ** -0.5,
                                          outp.data_ptr(), part.data_ptr(),
                                          stream())))
        if kind == "bfloat16":
            kh = kl.view(b, length, 32, 128).transpose(1, 2)
            vh = vl.view(b, length, 32, 128).transpose(1, 2)
            qq = q[:, :, None, :].to(kh.dtype)
            mask = bias[:, None, None, :].to(kh.dtype)
            fns.append(("sdpa", lambda: F.scaled_dot_product_attention(
                qq, kh, vh, attn_mask=mask)))
        for _, fn in fns:
            fn()
        torch.cuda.synchronize()
        want = da.decode_attention(q, k, v, 1, bias, ks, vs)
        tol = cs.DECODE_TOL[k.dtype]
        for key, out in outs.items():
            if key in SAME_FUNCTION or key == "dec_parent":
                torch.testing.assert_close(out.float(), want.float(),
                                           atol=tol, rtol=tol)
        times = in_turns(fns)
        extra = ""
        if b == 1:
            spl = []
            for m in (4, 5, 8):
                mrows = cdiv(length, m)
                run = ours(da._library(), mrows, cdiv(length, mrows))
                spl.append(f"{m}: {cs.device_ms(run, n=30):.4f}")
            extra = " | package by split count " + ", ".join(spl)
        print(f"#11 B={b} L={length} {kind} cache, {n} split(s): "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + extra,
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_levers: CUDA is not available")
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    libs = build_all(parent)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    probe_qmm(libs, device, sm, stream)
    probe_dec(libs, device, sm, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
