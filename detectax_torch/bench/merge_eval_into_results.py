"""Merge a regenerated eval.json back into a RESULTS_*.json family row.

Port of `benchmarks/merge_eval_into_results.py` (JSON only, no device).
An eval-only refresh: the training provenance fields (train_steps,
train_min, backbone, recipe, run_dir) of the existing row are kept and
the metric fields are replaced with the regenerated summary.

Staleness guard: the eval.json must be NEWER than the RESULTS file. A
regenerated eval always is, because the RESULTS file was last written
when the row being refreshed was produced; an older one is what a failed
re-evaluation leaves behind. Override with --allow_stale only when you
know the eval is the one you mean. A family not already present in the
RESULTS file is an error (an eval-only refresh cannot invent training
provenance); use --allow_new to add one.

Usage: python -m detectax_torch.bench.merge_eval_into_results \\
           RESULTS.json family eval.json [--allow_stale] [--allow_new]
"""
import argparse
import json
import os

KEEP = ("train_steps", "train_min", "backbone", "recipe", "run_dir")


def merge(results_path, family, eval_path, *, allow_stale=False,
          allow_new=False):
    with open(results_path) as f:
        results = json.load(f)
    if family not in results and not allow_new:
        raise SystemExit(
            f"family '{family}' is not in {results_path} (have: "
            f"{sorted(results)}); an eval-only refresh cannot create a row "
            "with no training provenance — pass --allow_new to add one"
        )
    if not allow_stale:
        eval_mtime = os.path.getmtime(eval_path)
        results_mtime = os.path.getmtime(results_path)
        if eval_mtime <= results_mtime:
            raise SystemExit(
                f"STALE MERGE REFUSED: {eval_path} "
                f"(mtime {eval_mtime:.0f}) is not newer than "
                f"{results_path} (mtime {results_mtime:.0f}) — the eval "
                "that was supposed to regenerate it likely failed "
                "(r4 incident: a failed re-eval silently republished old "
                "numbers). Re-run the eval, or pass --allow_stale."
            )
    with open(eval_path) as f:
        summary = json.load(f)
    old = results.get(family, {})
    for k in KEEP:
        if k in old:
            summary[k] = old[k]
    results[family] = summary
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"merged {family}: mAP@0.5={summary.get('mAP@0.5')}, "
          f"AP_small={summary.get('AP_small')}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("results_path")
    p.add_argument("family")
    p.add_argument("eval_path")
    p.add_argument("--allow_stale", action="store_true")
    p.add_argument("--allow_new", action="store_true")
    a = p.parse_args(argv)
    merge(a.results_path, a.family, a.eval_path,
          allow_stale=a.allow_stale, allow_new=a.allow_new)


if __name__ == "__main__":
    main()
