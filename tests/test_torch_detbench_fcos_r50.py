"""`detbench_fcos_r50.py --seed`: passed through to the trainer's
``--seed`` and written into ``result.json``'s fields; 0 by default."""
from __future__ import annotations

import pytest

import detbench_fcos_r50 as script


@pytest.mark.parametrize("argv, seed", [([], "0"), (["--seed", "3"], "3")])
def test_seed_reaches_the_trainer_and_the_result(argv, seed, monkeypatch,
                                                 tmp_path):
    seen = {}

    def fake_run(out, *, name, dataset, train, evaluate_argv, result,
                 keep=False):
        seen["result"] = result
        train(str(tmp_path / "ckpt"), out)
        return result

    def fake_train(train_argv):
        seen["argv"] = train_argv
        return {}

    from detectax_torch.cli import train_fcos

    monkeypatch.setattr(script, "run", fake_run)
    monkeypatch.setattr(train_fcos, "main", fake_train)
    trunk = tmp_path / "trunk.npz"
    trunk.write_bytes(b"")
    script.main(["--out", str(tmp_path / "out"), "--trunk", str(trunk),
                 *argv])
    a = seen["argv"]
    assert a[a.index("--seed") + 1] == seed
    assert seen["result"]["seed"] == int(seed)
