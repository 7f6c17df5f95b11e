"""The `serve` driver: `serve/service.py`'s HTTP front over a
`BatchingRetrievalService`, with a resident gallery, under open-loop
arrivals from a child process that imports no torch (`cirbench.loadgen`).

Queries are `/retrieve` by reference name at a fixed rate. Every seed
offers the same number of queries, the same set of gaps between them (the
quantiles of the exponential distribution at the mix's rate) and the same
set of caption lengths, each in another order, with names drawn uniformly
over the gallery. A sample of the queries, drawn from the seed, keeps its
answers; once the window has closed the plain reference ranks the gallery
for each and judges the returned lists.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Dict, List

import numpy as np

from cirbench import gen
from cirbench.families import build_program, reference
from cirbench.harness import ROOT, Cell, sub_seed
from cirbench.weights import (load_weights, make_weights, param_shapes,
                              reference_names)


def gallery(cell: Cell, seed: int, dim: int, device):
    """Target rows (unit, in the mix's dtype, on the device) and refer rows
    (host float32) of the resident gallery."""
    import torch

    t = cell.traffic
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, gen.GALLERY))
    target = torch.nn.functional.normalize(
        torch.randn((t["gallery"], dim), generator=g, device=device), dim=-1)
    target = target.to(getattr(torch, t["gallery_dtype"]))
    refer = torch.randn((t["gallery"], dim), generator=g, device=device)
    return target, refer.mul_(t["refer_scale"]).cpu().numpy()


def plan(cell: Cell, seed: int, rate: float, seconds: float,
         stream: int = 0) -> List[dict]:
    """The queries of one window: due times and bodies. `stream` 0 is the
    measured window's; the warm-up and the profiler window draw others."""
    t = cell.traffic
    n = max(1, int(round(rate * seconds)))
    r = gen.rng(seed, gen.ARRIVALS, int(rate * 1000), stream)
    gaps = r.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.cumsum(gaps) - gaps[0]
    lo, hi = t["caption_words"]
    lengths = r.permutation(lo + np.arange(n) % (hi - lo + 1))
    names = r.integers(0, t["gallery"], size=n)
    out = []
    for i in range(n):
        words = [gen.WORDS[j] for j in r.integers(0, len(gen.WORDS),
                                                    size=lengths[i])]
        out.append({"due": float(due[i]),
                    "body": {"reference_name": _name(int(names[i])),
                             "caption": " ".join(words), "k": t["k"]}})
    return out


def _name(gid: int) -> str:
    return f"img{gid:06d}"


class Server:
    """The program under test: backbone, gallery index, batching service
    and HTTP front on a free local port."""

    def __init__(self, cell: Cell, seed: int, device, faults=()):
        from spn4cir_tpu_torch.eval.retrieval import GalleryIndex
        from spn4cir_tpu_torch.serve.service import (BatchingRetrievalService,
                                                     serve)

        cfg, t = cell.config, cell.traffic
        self.backbone = build_program(cfg, device)
        self.shapes = param_shapes(self.backbone)
        self.wseed = sub_seed(seed, gen.WEIGHTS)
        weights = make_weights(self.shapes, self.wseed, device,
                               cfg.get("scalars", {}))
        load_weights(self.backbone, weights)
        del weights
        self.backbone.eval()
        self.target, self.refer = gallery(cell, seed, cfg["embed_dim"], device)
        index = GalleryIndex(target=self.target, refer=self.refer,
                             names=[_name(i) for i in range(t["gallery"])])
        self.service = BatchingRetrievalService(
            self.backbone, index, max_batch=t["max_batch"],
            max_delay_s=t["max_delay_s"], default_k=t["k"])
        if faults:
            _plant(self.service, faults)
        self.http = serve(self.service, host="127.0.0.1", port=0)
        self.port = self.http.server_address[1]

    def warm(self, seed: int) -> None:
        """Every dispatch size the batching can form, then a few queries
        over HTTP."""
        from spn4cir_tpu_torch.serve.service import _round_up_k

        svc, t = self.service, self.service.index
        kk = _round_up_k(svc.default_k)
        r = gen.rng(seed, gen.SAMPLE, 1)
        for b in range(1, svc.max_batch + 1):
            gids = r.integers(0, len(t.names), size=b)
            caps = gen.captions(r, b, (8, 24))
            svc._dispatch(t, t.refer_rows(gids), caps, gids, kk)
        from cirbench.loadgen import send

        for q in plan_like(r, 4):
            send(self.port, json.dumps(q).encode(), 60.0)

    def close(self) -> None:
        self.http.shutdown()
        self.http.server_close()


def plan_like(r, n: int) -> List[dict]:
    return [{"reference_name": _name(0), "caption": c, "k": 50}
            for c in gen.captions(r, n, (8, 24))]


class Load:
    """One run of the load generator over `queries`, started `lead` seconds
    ahead of its first due time (the child's own start-up)."""

    def __init__(self, server: Server, queries: List[dict], keep,
                 scratch: str, lead: float = 0.5):
        self.plan_path = os.path.join(scratch, "plan.json")
        self.out_path = os.path.join(scratch, "records.json")
        self.start = time.monotonic() + lead
        self.seconds = queries[-1]["due"] if queries else 0.0
        with open(self.plan_path, "w") as fh:
            json.dump({"port": server.port, "start": self.start,
                       "timeout_s": 60.0,
                       "keep": sorted(keep), "queries": queries}, fh)
        self.child = subprocess.Popen(
            [sys.executable, "-m", "cirbench.loadgen", self.plan_path,
             self.out_path], cwd=str(ROOT))

    def records(self) -> List[dict]:
        """Wait for the generator (a minute past its last due time at
        most); its records."""
        try:
            self.child.wait(timeout=self.start - time.monotonic()
                            + self.seconds + 120)
        finally:
            if self.child.poll() is None:
                self.child.kill()
                self.child.wait()
        if self.child.returncode != 0:
            raise RuntimeError(
                f"the load generator exited {self.child.returncode}")
        with open(self.out_path) as fh:
            records = json.load(fh)
        os.remove(self.plan_path)
        os.remove(self.out_path)
        return records


def offer(server: Server, queries: List[dict], keep, scratch: str
          ) -> List[dict]:
    return Load(server, queries, keep, scratch).records()


def pct(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    return float(np.percentile(np.asarray(values), q))


def summary(records: List[dict]) -> Dict[str, float]:
    ok = [r for r in records if r["status"] == 200]
    lat = [1e3 * r["latency"] for r in ok]
    late = [1e3 * r["late"] for r in records]
    return {"queries": len(records), "failed": len(records) - len(ok),
            "p50_ms": pct(lat, 50) if lat else float("inf"),
            "p95_ms": pct(lat, 95) if lat else float("inf"),
            "late_p50_ms": pct(late, 50), "late_p99_ms": pct(late, 99),
            "late_max_ms": max(late)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, scratch: str, faults=()) -> Dict[str, Any]:
    """One run. `faults` (the CPU tests'): 'answer' alters one returned id
    of every dispatch; 'half_batch' answers the second half of a dispatch
    with the first half's lists."""
    import torch

    from cirbench.harness import read_counters
    from cirbench.trace import profile_window

    t = cell.traffic
    cuda = torch.device(device).type == "cuda"
    server = Server(cell, seed, device, faults)
    try:
        server.warm(seed)
        # the load itself, briefly: threads, pools and allocator settle
        offer(server, plan(cell, seed, t["rate"], t["warm_seconds"], 1), (),
              scratch)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        queries = plan(cell, seed, t["rate"], seconds)
        r = gen.rng(seed, gen.SAMPLE)
        keep = set(r.choice(len(queries), size=min(t["check_queries"],
                                                   len(queries)),
                            replace=False).tolist())
        setup_s = time.perf_counter() - t_start
        before = server.service.metrics()
        read_counters(reset=True)
        records = offer(server, queries, keep, scratch)
        after = server.service.metrics()
        s = summary(records)
        out: Dict[str, Any] = {
            "notes": ["window launches " + str(read_counters()),
                      "load generator " + json.dumps(s)],
            "setup_s": setup_s, "attempted": s["queries"],
            "failed": s["failed"],
            "end_to_end": {"query_p50_ms": s["p50_ms"],
                           "query_p95_ms": s["p95_ms"]},
            "service": {k: after[k] - before[k]
                        for k in ("queries", "dispatches")},
        }
        if trace:
            profile_window(lambda: 0, scratch)      # the profiler's start-up
            load = Load(server, plan(cell, seed, t["rate"],
                                     t["profile_seconds"], 2), (), scratch,
                        lead=1.0)

            read_counters(reset=True)
            time.sleep(max(0.0, load.start - 0.05 - time.monotonic()))
            out["trace"] = profile_window(load.records, scratch)
            out["counters"] = read_counters()
        out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                    if cuda else 0)
        out["shapes"] = {"family": cell.config["family"],
                         "config": cell.config}
        shapes, wseed = server.shapes, server.wseed
        target, refer = server.target, server.refer
    finally:
        server.close()
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept = [(queries[i]["body"], json.loads(records[i]["body"])["results"])
            for i in sorted(keep) if records[i]["status"] == 200]
    out["values"] = check(cell.config, shapes, wseed, target, refer, kept,
                          device)
    return out


def reference_lists(cfg, shapes, wseed, target, refer, bodies, device,
                    precision: str = "float32"):
    """The plain reference's scores of every gallery row for each query
    body (reference excluded), on the host."""
    import torch

    from cirbench.reference.common import (Precision, l2_normalize,
                                           strict_float32)

    ref = reference(cfg)
    weights = reference_names(make_weights(
        shapes, wseed, device, cfg.get("scalars", {})))
    tok = ref.tokenizer(cfg)
    out = []
    with torch.no_grad(), strict_float32():
        for i in range(0, len(bodies), 64):
            chunk = bodies[i:i + 64]
            ids = ref.text_inputs(tok, [b["caption"] for b in chunk], cfg,
                                  device)
            text = ref.encode_text(weights, ids, cfg["transformer_layers"],
                                   cfg["transformer_heads"],
                                   Precision(precision))
            gids = [int(b["reference_name"][3:]) for b in chunk]
            rows = torch.from_numpy(refer[gids]).to(device)
            query = l2_normalize(rows.float() + text)
            scores = query @ target.float().t()
            scores[torch.arange(len(gids)), torch.tensor(gids)] = float("-inf")
            out.extend(scores.cpu())
    return out


def list_gaps(bodies, lists, scores) -> Dict[str, float]:
    """score_gap: the widest gap between a returned score and the
    reference's score of that gallery image; rank_gap: how far below the
    reference's k-th best score the lowest returned image lies. A list
    that is short, repeats an image or holds the reference reads inf."""
    score_gap = rank_gap = 0.0
    for body, items, row in zip(bodies, lists, scores):
        k = body["k"]
        gids = [int(it["name"][3:]) for it in items]
        if len(gids) != k or len(set(gids)) != k:
            return {"score_gap": float("inf"), "rank_gap": float("inf")}
        ref_scores = row[gids].double()
        if not bool(ref_scores.isfinite().all()):
            return {"score_gap": float("inf"), "rank_gap": float("inf")}
        got = np.asarray([it["score"] for it in items], np.float64)
        score_gap = max(score_gap, float(np.abs(got - ref_scores.numpy()).max()))
        kth = float(row.double().topk(k).values[-1])
        rank_gap = max(rank_gap, kth - float(ref_scores.min()))
    return {"score_gap": score_gap, "rank_gap": rank_gap}


def check(cfg, shapes, wseed, target, refer, kept, device) -> Dict[str, float]:
    bodies = [b for b, _ in kept]
    scores = reference_lists(cfg, shapes, wseed, target, refer, bodies, device)
    return list_gaps(bodies, [items for _, items in kept], scores)


def calibrate(cell: Cell, seed: int, device, what) -> Dict[str, Dict]:
    """The control: the reference's text tower in float8 put in the
    program's place, its top-k lists judged against the float32
    reference's scores."""
    import torch

    cfg, t = cell.config, cell.traffic
    shapes = param_shapes(build_program(cfg, "meta"))
    wseed = sub_seed(seed, gen.WEIGHTS)
    target, refer = gallery(cell, seed, cfg["embed_dim"], device)
    queries = plan(cell, seed, t["rate"], 20.0)
    r = gen.rng(seed, gen.SAMPLE)
    bodies = [queries[i]["body"] for i in sorted(r.choice(
        len(queries), size=t["check_queries"], replace=False).tolist())]
    base = reference_lists(cfg, shapes, wseed, target, refer, bodies, device)
    out = {}
    if "control" in what:
        low = reference_lists(cfg, shapes, wseed, target, refer, bodies,
                              device, "fp8")
        lists = []
        for b, row in zip(bodies, low):
            vals, idx = torch.sort(row, descending=True, stable=True)
            lists.append([{"name": _name(int(i)), "score": float(v)}
                          for v, i in zip(vals[:b["k"]], idx[:b["k"]])])
        out["control"] = list_gaps(bodies, lists, base)
    return out


def sweep(cell: Cell, seed: int, seconds: float, rates, device):
    """Offer each rate once on one server; what it sustained."""
    import tempfile

    server = Server(cell, seed, device)
    scratch = tempfile.mkdtemp(prefix="cirbench-sweep-")
    try:
        server.warm(seed)
        offer(server, plan(cell, seed, rates[0], 2.0, 1), (), scratch)
        for rate in rates:
            queries = plan(cell, seed, rate, seconds)
            before = server.service.metrics()
            t0 = time.monotonic()
            records = offer(server, queries, (), scratch)
            wall = time.monotonic() - t0
            after = server.service.metrics()
            s = summary(records)
            q = len(records) // 4
            tail = [r["latency"] for r in records[-q:] if r["status"] == 200]
            head = [r["latency"] for r in records[:q] if r["status"] == 200]
            yield {"rate": rate, **s, "wall_s": wall,
                   "completed_per_s": (len(records) - s["failed"]) / wall,
                   "first_quarter_p50_ms": 1e3 * statistics.median(head),
                   "last_quarter_p50_ms": 1e3 * statistics.median(tail),
                   "queries_per_dispatch": (after["queries"] - before["queries"])
                   / max(1, after["dispatches"] - before["dispatches"])}
    finally:
        server.close()
        import shutil
        shutil.rmtree(scratch, ignore_errors=True)


def _plant(service, faults) -> None:
    dispatch = service._dispatch

    def planted(index, refer, captions, gids, kk):
        vals, idx = dispatch(index, refer, captions, gids, kk)
        idx = idx.copy()
        if "answer" in faults:
            idx[0, 0] = (idx[0, 0] + 1) % len(index.names)
        if "half_batch" in faults and len(captions) > 1:
            h = len(captions) // 2
            idx[h:2 * h] = idx[:h]
            vals = vals.copy()
            vals[h:2 * h] = vals[:h]
        return vals, idx
    service._dispatch = planted
