#!/usr/bin/env python3
"""Levers of the max-over-query InfoNCE kernels #9 (forward) and #10
(backward), and the parent's kernels, on one NVIDIA GPU.

    python3 chip_probes/max_query_levers.py [<parent checkout>]

Builds, beside the package's kernels in build/kernels/levers/, variants of
`csrc/max_query_infonce.cu`, each made by replacing lines of the package's
source (every replacement must match):

  `tf32`      #9 over bf16 and int8 banks in split TF32 (two m16n8k8
              products a step), as over float32 (the package: bf16
              products, m16n8k16, of feats as three exact bf16 terms);
  `scan`      #9's epilogue at Q = 32 by the staged scan that serves every
              other Q (the package: registers and shuffles);
  `copy`      #9's products skipped: its cp.async ring and epilogue alone;
  `compute`   #9's bank copies skipped: its products and epilogue alone
              (on whatever the ring holds);
  `bwd_copy`  #10's FMAs skipped: the residual reads and the routed-row
              gathers alone;
  `redux`     #10's distinct routes at Q <= 32 as one warp-wide OR of
              1 << q (`__reduce_or_sync`), ranked by q (the package:
              `__match_any_sync`, ranked by lane), for this probe's Q = 32;
  `ahead2`    #10's routes loaded two stages ahead of their issue, in two
              register sets (the package: one);
  `stages2`, `stages4`  a ring of two or four stages in both kernels (the
              package: 3; four do not fit #9 at D = 512, so the variant
              drops that assertion);
  `ilp`       #9's split-TF32 products of a step (a float32 bank; bf16 and
              int8 under `tf32`) issued by kind (all lo·hi, then all
              hi·lo, then all hi·hi) instead of accumulator by accumulator:
              each accumulator sums in the same order (the same bits), its
              dependent products eight instructions apart;

and, given a parent checkout (a `git archive` of the parent commit,
unpacked), the parent's source with its own C interface and plan (#10
there recomputes the sims). It reads the device time of back-to-back
launches (`chip_smoke.device_ms`) at blip2's stage-2 shape (B = 32,
M = 65,536, Q = 32, D = 256) over float32, bf16 and int8 banks, in turns:
package, variants, parent, then the same reversed; each reading is the
mean of its two turns. `stages*` and the parent are held against the
package's output within the smoke's tolerances (the parent's routes and
statistics come from its own forward). Prints one line per bank type and
kernel; exits non-zero where no GPU is found.
"""

import concurrent.futures
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spn4cir_tpu_torch.ops import bank_kernels as bk  # noqa: E402
from spn4cir_tpu_torch.ops import cuda_build  # noqa: E402
from spn4cir_tpu_torch.ops import maxquery_kernels as mk  # noqa: E402

SRC = "max_query_infonce.cu"
VARIANTS = {
    "copy": [("              mma_step_split<(sizeof(T) < 4)>(part, ah, al, bv);",
              ""),
             ("                for (int tm = 2; tm >= 0; --tm) mma16816(",
              "                for (int tm = 2; tm >= 0 && false; --tm) mma16816(")],
    "tf32": [("constexpr bool kBf16Route = sizeof(T) < 4;",
              "constexpr bool kBf16Route = false;")],
    "scan": [("  const bool q32 = Q == 32;  // the register epilogue",
              "  const bool q32 = false;")],
    "compute": [("        cp_async16(st + r * kSliceBytes",
                 "        if (false) cp_async16(st + r * kSliceBytes")],
    "ahead2": [("""  load_routes(kStages - 1, rq);  // a stage ahead of its issue
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1's slots
    issue(s + kStages - 1, rq);
    load_routes(s + kStages, rq);  // used by the next iteration's issue
    accumulate(s);
  }""", """  int rq_b[kMaxStageM];
  load_routes(kStages - 1, rq);
  load_routes(kStages, rq_b);
  auto step = [&](int s, int (&r)[kMaxStageM]) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1, r);
    load_routes(s + kStages + 1, r);
    accumulate(s);
  };
  for (int s = 0; s < n_st; s += 2) {
    step(s, rq);
    if (s + 1 < n_st) step(s + 1, rq_b);
  }""")],
    "bwd_copy": [("        if (row0 + 4 * warp + i >= B) break;",
                  "        if (row0 + 4 * warp + i >= B || true) break;")],
    "stages2": [("constexpr int kStages = 3; ", "constexpr int kStages = 2; ")],
    "stages4": [("constexpr int kStages = 3; ", "constexpr int kStages = 4; "),
                ("static_assert(size_t(kMaxD) * 256 + size_t(kStages) * "
                 "kStageBytes <= kSmemLimit,\n              \"the widest D "
                 "must fit\");", ""),
                ("static_assert(bwd_smem_bytes<float>(kMaxD) <= kSmemLimit, "
                 "\"the widest D must fit\");", "")],
}
ILP_STEP = """            {
              constexpr bool kExactB = sizeof(T) < 4;
              uint32_t bh[4][2], bl[4][2];
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  if (kExactB)
                    bh[ni][j] = __float_as_uint(bv[ni][j]);
                  else
                    split_tf32(bv[ni][j], bh[ni][j], bl[ni][j]);
                }
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
                  mma1688_tf32(part[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
              if (!kExactB)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                  for (int mi = 0; mi < 2; ++mi)
                    mma1688_tf32(part[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
                  mma1688_tf32(part[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
            }"""
VARIANTS["ilp"] = [("              mma_step_split<(sizeof(T) < 4)>(part, ah, al, bv);",
                    ILP_STEP)]
MATCH_DEDUPE = """        const unsigned same = __match_any_sync(kFull, q);
        const int first = __ffs(same) - 1;
        const unsigned owners = __ballot_sync(kFull, first == lane && q >= 0);
        if (warp == u) {  // the stage's arrays for this m, lane = row
          const int k = u * kRows + lane;
          slot_s[st * kMaxStageM * kRows + k] = q >= 0 ? __popc(owners & ((1u << first) - 1)) : -1;
          cp_async4(lg_s + st * kMaxStageM * kRows + k,
                    args.logits_t + (q >= 0 ? size_t(m) * B + row0 + lane : 0), q >= 0);
          if constexpr (kQuant)
            cp_async4(sc_s + st * kMaxStageM * kRows + k,
                      args.scales + (q >= 0 ? size_t(m) * Q + q : 0), q >= 0);
        }
        // distinct row k (in lane order) goes to slot u * kRows + k, copied
        // by warp k % 8: this warp's rows k = warp + 8j, each found by a
        // ballot of the owner of rank k
        const int rank = __popc(owners & ((1u << lane) - 1));
#pragma unroll
        for (int j = 0; j < kRows / (kThreads / 32); ++j) {
          const int k = warp + (kThreads / 32) * j;
          const unsigned who = __ballot_sync(kFull, first == lane && q >= 0 && rank == k);
          if (who == 0u) break;  // ranks are dense: none past this one
          const int qk = __shfl_sync(kFull, q, __ffs(who) - 1);
"""
REDUX_DEDUPE = """        const unsigned qs = __reduce_or_sync(kFull, q >= 0 ? 1u << q : 0u);
        if (warp == u) {
          const int k = u * kRows + lane;
          slot_s[st * kMaxStageM * kRows + k] = q >= 0 ? __popc(qs & ((1u << q) - 1)) : -1;
          cp_async4(lg_s + st * kMaxStageM * kRows + k,
                    args.logits_t + (q >= 0 ? size_t(m) * B + row0 + lane : 0), q >= 0);
          if constexpr (kQuant)
            cp_async4(sc_s + st * kMaxStageM * kRows + k,
                      args.scales + (q >= 0 ? size_t(m) * Q + q : 0), q >= 0);
        }
        const int n_rows = __popc(qs);
#pragma unroll
        for (int j = 0; j < kRows / (kThreads / 32); ++j) {
          const int k = warp + (kThreads / 32) * j;
          if (k >= n_rows) break;
          const int qk = __fns(qs, 0, k + 1);
"""
VARIANTS["redux"] = [(MATCH_DEDUPE, REDUX_DEDUPE)]
SAME_FUNCTION = ("stages2", "stages4", "ilp", "ahead2", "tf32", "scan",
                 "redux")
FWD_ONLY = ("copy", "compute", "ilp", "tf32", "scan")  # variants of #9 alone
BWD_ONLY = ("bwd_copy", "ahead2", "redux")
PTR, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def cdiv(a, b):
    return -(-a // b)


def build_all(parent):
    """name -> loaded library: the variants and, given, the parent's."""
    out_dir = cuda_build.BUILD_DIR / "levers"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, subs in VARIANTS.items():
        text = (cuda_build.CSRC_DIR / SRC).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} matches "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        path = out_dir / f"mq_{name}.cu"
        path.write_text(text)
        sources[name] = (path, cuda_build.CSRC_DIR)
    if parent:
        csrc = os.path.join(parent, "spn4cir_tpu_torch", "csrc")
        sources["parent"] = (os.path.join(csrc, SRC), csrc)

    def one(name):
        src, inc = sources[name]
        lib = out_dir / f"mq_{name}.so"
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
        if name == "parent":
            lib.max_query_infonce_fwd.argtypes = ([PTR] * 4 + [F32] + [I32] * 7
                                                  + [PTR] * 7)
            lib.max_query_infonce_bwd.argtypes = ([PTR] * 7 + [F32] + [I32] * 7
                                                  + [PTR] * 3)
        else:
            lib.max_query_infonce_fwd.argtypes = ([PTR] * 4 + [F32] + [I32] * 7
                                                  + [PTR] * 9)
            lib.max_query_infonce_bwd.argtypes = ([PTR] * 8 + [F32] + [I32] * 7
                                                  + [PTR] * 3)
    return libs


def parent_plan(m, b, sm):
    """The parent's `split_plan`: tiles of 256 m's, about one CTA an SM."""
    tiles = cdiv(m, 256)
    want = max(1, sm // cdiv(b, 32))
    per = cdiv(tiles, want)
    return per, cdiv(tiles, per)


def in_turns(fns):
    """Each (name, fn) timed in the order given and again reversed; the
    mean of its two readings."""
    got = {}
    for name, fn in list(fns) + list(reversed(fns)):
        got.setdefault(name, []).append(cs.device_ms(fn, n=20))
    return {k: sum(v) / len(v) for k, v in got.items()}


def probe(libs, device, sm, stream):
    g = torch.Generator(device=device).manual_seed(13)
    b, m, nq, d, tau = (cs.BLIP2_BATCH, cs.RECIPE_BANK, cs.BLIP2_QUERIES,
                        cs.BLIP_DIM, cs.BLIP2_TAU)
    q = cs.unit_rows(b, d, g, device)
    bank32 = cs.unit_bank(m, nq, d, g, device)
    labels = torch.randint(0, m, (b,), generator=g, device=device)
    labels32 = labels.to(torch.int32)
    gout = torch.tensor(1.0, device=device)
    for bank in (bank32, bank32.to(torch.bfloat16), bk.quantize_bank(bank32)):
        values, scales, code, _, _ = mk._bank_args(bank)
        plan = mk.mq_plan(b, m, nq, sm)
        loss, stats, dtau, res = mk.max_query_infonce_fwd(
            q, bank, labels, tau, routing=True)
        dq = mk.max_query_infonce_bwd(bank, labels, tau, stats[0], stats[1],
                                      gout, res)
        logits_t, route_t = res[0].t(), res[1].t()
        outs = {}

        def ours(lib, key):
            part = torch.empty(plan.n_splits, b, 4, device=device)
            st = torch.empty(4, b, device=device)
            out2 = torch.empty(2, device=device)
            lt = torch.empty(m, b, device=device)
            rt = torch.empty(m, b, device=device, dtype=torch.int16)
            dq_part = torch.empty(plan.bwd_splits, b, d, device=device)
            dqv = torch.empty(b, d, device=device)
            outs[key] = (out2, st, lt, rt, dqv)

            def fwd():
                err = lib.max_query_infonce_fwd(
                    q.data_ptr(), values, scales, labels32.data_ptr(), tau, b,
                    m, nq, d, code, plan.m_per_split, plan.n_splits,
                    part.data_ptr(), st[0].data_ptr(), st[1].data_ptr(),
                    st[2].data_ptr(), st[3].data_ptr(), out2.data_ptr(),
                    lt.data_ptr(), rt.data_ptr(), stream())
                assert err == 0, err

            def bwd():  # from the package's residuals and statistics
                err = lib.max_query_infonce_bwd(
                    values, scales, labels32.data_ptr(), stats[0].data_ptr(),
                    stats[1].data_ptr(), gout.data_ptr(),
                    logits_t.data_ptr(), route_t.data_ptr(), tau, b, m, nq, d,
                    code, plan.bwd_m_per_split, plan.bwd_splits,
                    dq_part.data_ptr(), dqv.data_ptr(), stream())
                assert err == 0, err
            return fwd, bwd

        fns = {"fwd": [("package", lambda: mk.max_query_infonce_fwd(
                   q, bank, labels, tau, routing=True))],
               "bwd": [("package", lambda: mk.max_query_infonce_bwd(
                   bank, labels, tau, stats[0], stats[1], gout, res))]}
        for key in VARIANTS:
            fwd, bwd = ours(libs[key], key)
            if key not in BWD_ONLY:
                fns["fwd"].append((key, fwd))
            if key not in FWD_ONLY:
                fns["bwd"].append((key, bwd))
        if "parent" in libs:
            lib = libs["parent"]
            tps, pn = parent_plan(m, b, sm)
            ppart = torch.empty(pn, b, 4, device=device)
            pst = torch.empty(4, b, device=device)
            pout2 = torch.empty(2, device=device)
            pdq_part = torch.empty(pn, b, d, device=device)
            pdq = torch.empty(b, d, device=device)
            outs["parent"] = (pout2, pst, None, None, pdq)

            def pfwd():
                err = lib.max_query_infonce_fwd(
                    q.data_ptr(), values, scales, labels32.data_ptr(), tau, b,
                    m, nq, d, code, tps, pn, ppart.data_ptr(),
                    pst[0].data_ptr(), pst[1].data_ptr(), pst[2].data_ptr(),
                    pst[3].data_ptr(), pout2.data_ptr(), stream())
                assert err == 0, err

            def pbwd():
                err = lib.max_query_infonce_bwd(
                    q.data_ptr(), values, scales, labels32.data_ptr(),
                    pst[0].data_ptr(), pst[1].data_ptr(), gout.data_ptr(),
                    tau, b, m, nq, d, code, tps, pn, pdq_part.data_ptr(),
                    pdq.data_ptr(), stream())
                assert err == 0, err
            fns["fwd"].append(("parent", pfwd))
            fns["bwd"].append(("parent", pbwd))
        for group in fns.values():
            for _, fn in group:
                fn()
        torch.cuda.synchronize()
        for key, (out2, st, lt, rt, dqv) in outs.items():
            if key not in SAME_FUNCTION + ("parent",):
                continue
            if key not in BWD_ONLY:  # the forward ran
                torch.testing.assert_close(out2[0], loss, atol=cs.BANK_RTOL,
                                           rtol=cs.BANK_RTOL)
                for a, b_ in zip(st, stats):
                    torch.testing.assert_close(a, b_, atol=cs.BANK_RTOL,
                                               rtol=cs.BANK_RTOL)
                if lt is not None:
                    torch.testing.assert_close(lt, logits_t,
                                               atol=cs.BANK_RTOL,
                                               rtol=cs.BANK_RTOL)
            if key not in FWD_ONLY:  # the backward ran
                torch.testing.assert_close(dqv, dq, atol=cs.BANK_DQ_ATOL,
                                           rtol=cs.BANK_RTOL)
            if key in ("ilp", "ahead2", "stages2", "stages4", "scan", "redux"):
                # the same sums in the same order: the same bits
                assert key in ("ahead2", "redux") or (
                    torch.equal(out2, torch.stack([loss, dtau]))
                    and torch.equal(lt, logits_t) and torch.equal(rt, route_t))
                assert key in ("ilp", "scan") or torch.equal(dqv, dq)
        kind = cs.dtype_name(bank.dtype)
        pair = [("package", lambda: (fns["fwd"][0][1](), fns["bwd"][0][1]()))]
        if "parent" in libs:
            pair.append(("parent", lambda: (pfwd(), pbwd())))
        for name, group in (("#9 forward", fns["fwd"]),
                            ("#10 backward", fns["bwd"]), ("#9 + #10", pair)):
            times = in_turns(group)
            print(f"{name} B={b} M={m} Q={nq} D={d} {kind} bank: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()),
                  flush=True)
        del bank, res
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("max_query_levers: CUDA is not available")
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda:0")
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    libs = build_all(parent)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    probe(libs, device, sm, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
