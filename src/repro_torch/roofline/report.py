"""Render the dry run's results JSON (``launch/dryrun.py``) as markdown
tables (the port of the JAX package's ``roofline/report.py``).  Every
roofline figure is a prediction against ``HW_H100``'s published peaks.

    python -m repro_torch.roofline.report dryrun_results.json
"""
from __future__ import annotations

import json
import sys
from typing import Dict

from .analysis import HW_H100


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}us"


def dryrun_table(results: Dict) -> str:
    rows = [
        "| arch | shape | mesh | status | params | param B/dev | "
        "cache B/dev | compile | HLO temp B/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        mesh = r.get("mesh_name", "?")
        status = ("SKIP" if "skipped" in r else
                  "OK" if r.get("ok") else "FAIL")
        mem = r.get("memory_analysis", {})
        rows.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | {status} | "
            f"{r.get('n_params', 0) / 1e9:.1f}B | "
            f"{_fmt_bytes(r.get('param_bytes_per_dev'))} | "
            f"{_fmt_bytes(r.get('cache_bytes_per_dev'))} | "
            f"{r.get('compile_s', 0):.1f}s | "
            f"{_fmt_bytes(mem.get('temp_size_in_bytes'))} |"
        )
    return "\n".join(rows)


def roofline_table(results: Dict) -> str:
    rows = [
        "| arch | shape | bottleneck | t_compute | t_memory | t_collective "
        "| bound | MODEL/HLO flops | step tokens/s bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("mesh_name") != "16x16" or not r.get("ok") \
                or "skipped" in r or "roofline" not in r:
            continue
        rl = r["roofline"]
        tokens = (r["global_batch"] * r["seq_len"]
                  if r["kind"] in ("train", "prefill") else r["global_batch"])
        tput = tokens / rl["bound_s"] if rl["bound_s"] else 0
        rows.append(
            f"| {r['arch']} | {r['shape']} | **{rl['bottleneck']}** | "
            f"{_fmt_s(rl['t_compute_s'])} | {_fmt_s(rl['t_memory_s'])} | "
            f"{_fmt_s(rl['t_collective_s'])} | {_fmt_s(rl['bound_s'])} | "
            f"{(r.get('useful_flops_ratio') or 0):.2f} | "
            f"{tput:,.0f} |"
        )
    return "\n".join(rows)


def skips_table(results: Dict) -> str:
    rows = ["| arch | shape | reason |", "|---|---|---|"]
    seen = set()
    for key in sorted(results):
        r = results[key]
        if "skipped" in r and (r["arch"], r["shape"]) not in seen:
            seen.add((r["arch"], r["shape"]))
            rows.append(f"| {r['arch']} | {r['shape']} | {r['skipped']} |")
    return "\n".join(rows)


def summarize(results: Dict) -> str:
    n_ok = sum(1 for r in results.values()
               if r.get("ok") and "skipped" not in r)
    n_skip = sum(1 for r in results.values() if "skipped" in r)
    n_fail = sum(1 for r in results.values() if not r.get("ok"))
    out = [
        f"cells: {len(results)} — compiled OK: {n_ok}, "
        f"skipped (per assignment rules): {n_skip}, failed: {n_fail}",
        "",
        "## Dry-run (both meshes)",
        "",
        dryrun_table(results),
        "",
        "## Skipped cells",
        "",
        skips_table(results),
        "",
        "## Roofline, predicted (single pod, 16x16 = 256 H100s; "
        f"{HW_H100['peak_flops_bf16'] / 1e12:.0f} TFLOP/s bf16, "
        f"{HW_H100['hbm_bw'] / 1e9:.0f} GB/s HBM, "
        f"{HW_H100['net_bw'] / 1e9:.0f} GB/s network per card)",
        "",
        roofline_table(results),
    ]
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    with open(path) as f:
        results = json.load(f)
    print(summarize(results))


if __name__ == "__main__":
    main()
