"""The port's `prepare-data` subcommand against the JAX package's, on the CPU.

- `prepare-data synthetic` (the defaults, and with a `--config` of its own
  sizes): the same JSON line from both CLIs, and the same arrays from both
  packages' `load_dataset` of what each wrote, bit for bit.
- A raw dataset that is not there: the JAX package's FileNotFoundError,
  naming the same file, dataset and directory, with the same placement
  hint; nothing is downloaded.
- `python -m seqrec_tpu_torch prepare-data synthetic` as a process prints
  the line last.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from seqrec_tpu import cli as jax_cli
from seqrec_tpu.config import DataConfig as JaxDataConfig
from seqrec_tpu.data.dataset import load_dataset as jax_load_dataset
from seqrec_tpu_torch import cli
from seqrec_tpu_torch.config import DataConfig
from seqrec_tpu_torch.data.dataset import load_dataset

ROOT = Path(__file__).resolve().parents[1]


def _lines(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(x) for x in out.getvalue().splitlines() if x.strip()]


@pytest.mark.parametrize("sizes", [None, {"synthetic_num_users": 70, "synthetic_num_items": 55,
                                          "synthetic_max_len": 9, "seed": 3}])
def test_prepare_data_synthetic_equals_the_jax_cli(tmp_path, sizes):
    extra = []
    if sizes is not None:
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({"data": {"dataset": "synthetic", **sizes}}))
        extra = ["--config", str(cfg)]
    got = _lines(cli.main, ["prepare-data", "synthetic", "--data_dir", str(tmp_path / "t"),
                            *extra])
    want = _lines(jax_cli.main, ["prepare-data", "synthetic", "--data_dir",
                                 str(tmp_path / "j"), *extra])
    assert got == want and len(got) == 1
    assert got[0]["dataset"] == "synthetic" and got[0]["num_interactions"] > 0
    if sizes is not None:
        assert got[0]["num_users"] == 70 and got[0]["num_items"] == 55
    kw = dict(dataset="synthetic", **(sizes or {}))
    t = load_dataset(DataConfig(data_dir=str(tmp_path / "t"), **kw))
    j = jax_load_dataset(JaxDataConfig(data_dir=str(tmp_path / "j"), **kw))
    assert (t.num_users, t.vocab_size) == (j.num_users, j.vocab_size)
    np.testing.assert_array_equal(t.items, j.items)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    assert sorted(p.name for p in (tmp_path / "t" / "synthetic").iterdir()) == sorted(
        p.name for p in (tmp_path / "j" / "synthetic").iterdir())


@pytest.mark.parametrize("name", ["ml-100k", "ml-1m"])
def test_prepare_data_without_the_raw_file_raises_the_jax_error(tmp_path, name):
    argv = ["prepare-data", name, "--data_dir", str(tmp_path)]
    with pytest.raises(FileNotFoundError) as want:
        jax_cli.main(argv)
    with pytest.raises(FileNotFoundError) as got:
        cli.main(argv)
    # The same file, dataset and directory, and the same placement hint; the
    # port says why in its own words ("nothing is downloaded").
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    assert str(got.value).endswith("; place it there manually)")
    assert str(want.value).endswith("; place it there manually)")
    assert not (tmp_path / name).exists() or not any((tmp_path / name).iterdir())


def test_prepare_data_runs_as_a_module(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "seqrec_tpu_torch", "prepare-data", "synthetic", "--data_dir",
         str(tmp_path)], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _lines(jax_cli.main, ["prepare-data", "synthetic", "--data_dir", str(tmp_path / "j")])
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == want[0]
