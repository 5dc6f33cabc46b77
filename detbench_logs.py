"""Hold a DetBench row's training log against the TPU row's log.

Reads the display lines (``step N | lr x | cls x | ... | num_pos x``) of
two logs that `benchmarks/run_detbench.py` or the port's
`detectax_torch.bench.run_detbench` wrote. In the row's log the last line
of a step counts: a row carried across runs repeats the steps between
its checkpoint and the stop, and the resumed run's lines are the row's.
In the TPU log the first run counts (a log may hold the same run twice),
or under ``--tpu_run last`` the last line of a step, as in the row's log:
a TPU log that holds two runs of one recipe whose second is its row's
(`benchmarks/runs_v2/centernet_heatmap/log.txt`: the first run, lines
2-55, was evaluated at 0.6448; the second, from line 83, is the row).

For every display step in both logs it compares `num_pos` (exactly: it
depends on the loader and the assignment alone, not on the weights) and
each loss (the row's over the TPU's). ``--shift N`` holds the row's step
s against the TPU's step s - N as well, for `num_pos` only: a trainer
resumed at step N restarts its loader from its seed, so its steps N + k
see the batches of steps k.

    python3 detbench_logs.py ROW_LOG TPU_LOG [--from_step 0] [--shift N]
        [--tpu_run first|last] [--out f.json]

Prints one JSON object (also written to ``--out``): the steps compared,
whether `num_pos` was equal at each, the first step where it was not, the
range of the ratio of each loss, and the mean `total` of both logs over
the compared steps; with ``--shift`` the same `num_pos` summary of the
shifted pairs under ``"shifted"``. It also holds the recipe: each
training command line of the row's log (``$ ... -m ...``, not
``.evaluate``) against the TPU log's first, ``detectax_torch.`` read as
``detectax.``, the path-valued flags (`PATH_FLAGS`) and the flags of a
run rather than a recipe (`RUN_FLAGS`: ``--resume``, ``--seed``) set
aside. ``recipe_equal`` is whether every such line matches, and
``recipe_diff`` names each flag that differs with the row's and the TPU's
values (null where a flag is absent); both are null where either log
holds no training command line.
"""
from __future__ import annotations

import argparse
import json
import re

LOSSES = ("cls", "reg", "cen", "total")
# flags whose values are paths of one machine, and flags of one run
PATH_FLAGS = ("--ckpt_dir", "--out_dir", "--init_backbone")
RUN_FLAGS = ("--resume", "--seed")


def _is_training(line: str) -> bool:
    return line.startswith("$ ") and " -m " in line and (
        ".evaluate" not in line)


def display_steps(path: str, *, first_run: bool = False) -> dict:
    """{step: {key: value}} of the display lines of ``path``; the last
    line of a step wins, or with ``first_run`` only the lines before the
    log's second training command count."""
    steps = {}
    runs = 0
    with open(path) as f:
        for line in f:
            if _is_training(line):
                runs += 1
                if first_run and runs > 1:
                    break
            m = re.match(r"step (\d+) \| (.*)", line.strip())
            if m:
                fields = dict(kv.split(" ", 1)
                              for kv in m.group(2).split(" | "))
                steps[int(m.group(1))] = {k: float(v)
                                          for k, v in fields.items()}
    return steps


def recipes(path: str) -> list:
    """The recipe of each training command line of ``path``: {"-m":
    module, flag: [values]}, the module's ``detectax_torch.`` read as
    ``detectax.``, a repeated flag's last values winning (as argparse
    takes them), `PATH_FLAGS` and `RUN_FLAGS` left out."""
    out = []
    with open(path) as f:
        for line in f:
            if not _is_training(line):
                continue
            words = line.split()
            words = words[words.index("-m") + 1:]
            recipe = {"-m": [re.sub(r"^detectax_torch\.", "detectax.",
                                    words[0])]}
            flag = None
            for w in words[1:]:
                if w.startswith("--"):
                    flag = w
                    recipe[flag] = []
                elif flag is not None:
                    recipe[flag].append(w)
            for k in PATH_FLAGS + RUN_FLAGS:
                recipe.pop(k, None)
            out.append(recipe)
    return out


def compare_recipes(row: list, tpu: list) -> dict:
    """``recipe_equal`` and ``recipe_diff`` ({flag: {"row", "tpu"}}) of
    every recipe in ``row`` against the first in ``tpu``."""
    if not row or not tpu:
        return {"recipe_equal": None, "recipe_diff": None}
    diff = {}
    for r in row:
        for k in sorted(set(r) | set(tpu[0])):
            if r.get(k) != tpu[0].get(k):
                diff.setdefault(k, {"row": r.get(k), "tpu": tpu[0].get(k)})
    return {"recipe_equal": not diff, "recipe_diff": diff}


def _num_pos(pairs) -> dict:
    diff = [s for s, a, b in pairs if a["num_pos"] != b["num_pos"]]
    return {"steps": len(pairs),
            "first_step": pairs[0][0] if pairs else None,
            "last_step": pairs[-1][0] if pairs else None,
            "num_pos_equal": not diff,
            "first_num_pos_diff": diff[0] if diff else None,
            "num_pos_diffs": len(diff)}


def compare(row: dict, tpu: dict, *, from_step: int = 0,
            shift: int | None = None) -> dict:
    pairs = [(s, row[s], tpu[s]) for s in sorted(row)
             if s >= from_step and s in tpu]
    out = _num_pos(pairs)
    for k in LOSSES:
        ratios = [a[k] / b[k] for _, a, b in pairs
                  if k in a and k in b and b[k] != 0]
        if ratios:
            out[f"{k}_ratio_min"] = min(ratios)
            out[f"{k}_ratio_max"] = max(ratios)
    if pairs:
        out["mean_total"] = sum(a["total"] for _, a, _ in pairs) / len(pairs)
        out["mean_total_tpu"] = (sum(b["total"] for _, _, b in pairs)
                                 / len(pairs))
    if shift is not None:
        shifted = [(s, row[s], tpu[s - shift]) for s in sorted(row)
                   if s > shift and s - shift in tpu]
        out["shifted"] = {"shift": shift, **_num_pos(shifted)}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("row_log")
    p.add_argument("tpu_log")
    p.add_argument("--from_step", type=int, default=0)
    p.add_argument("--shift", type=int, default=None)
    p.add_argument("--tpu_run", choices=("first", "last"), default="first",
                   help="which run of a TPU log that holds two counts")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    result = compare(display_steps(args.row_log),
                     display_steps(args.tpu_log,
                                   first_run=args.tpu_run == "first"),
                     from_step=args.from_step, shift=args.shift)
    result = {"row_log": args.row_log, "tpu_log": args.tpu_log,
              "tpu_run": args.tpu_run, **result,
              **compare_recipes(recipes(args.row_log),
                                recipes(args.tpu_log))}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
