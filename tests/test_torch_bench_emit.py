"""samd_tpu_torch.evaluation.bench_emit against samd_tpu.evaluation.bench_emit
on the same inputs: the same constants, the identical compact line (the
worst-case detail of ``tests/test_bench_emit.py`` and pathological ones),
byte-identical detail files and stdout lines over a partial emit and a
complete one, and a detail file that cannot be written reported on stderr
without stopping the run."""

import json

import pytest

from samd_tpu.evaluation import bench_emit as jax_emit
from samd_tpu_torch.evaluation import bench_emit
from test_bench_emit import _worst_case_detail


def test_constants_equal():
    assert bench_emit.HEADLINE_KEYS == jax_emit.HEADLINE_KEYS
    assert bench_emit.MAX_LINE == jax_emit.MAX_LINE


def _details():
    worst = _worst_case_detail()
    return {
        "worst_case": worst,
        "pathological": {k: "x" * 200 for k in jax_emit.HEADLINE_KEYS},
        "one_huge_first_key": {"ar_tokens_per_s": "y" * 5000,
                               "skipped_sections": ["a"] * 3},
        "detail_only_keys": {"phase_4_seconds": 12.5, "not_a_headline": 1},
        "empty": {},
        "mixed": {**worst, "extra": [1, 2, 3],
                  "skipped_sections": ["fused_sam"] * 400},
    }


@pytest.mark.parametrize("name", sorted(_details()))
@pytest.mark.parametrize("value,vs,complete", [(99.9999, 99.9999, True),
                                               (0.0, 0.0, False),
                                               (11.3, 6.1, True)])
def test_compact_line_identical(name, value, vs, complete):
    detail = _details()[name]
    want = jax_emit.compact_line(detail, value=value, vs_baseline=vs,
                                 complete=complete)
    got = bench_emit.compact_line(detail, value=value, vs_baseline=vs,
                                  complete=complete)
    assert got == want
    assert len(got) <= bench_emit.MAX_LINE
    assert json.loads(got)["metric"] == \
        "fused_sam_speedup_vs_own_ar_synthetic_1b"


def _run(module, path, capsys):
    """A partial emit, then a complete one; each step's detail file bytes
    and the stdout/stderr of the two emits."""
    detail = {}
    em = module.BenchEmitter(detail, path=path)
    detail["ar_tokens_per_s"] = 35.2
    em.emit()
    files = []
    try:
        with open(path, "rb") as f:
            files.append(f.read())
    except OSError:
        files.append(None)
    detail["fused_sam_tokens_per_s"] = 400.0
    detail["phase_4_seconds"] = 71.25
    em.value = 11.3
    em.vs_baseline = 6.1
    em.emit(complete=True)
    try:
        with open(path, "rb") as f:
            files.append(f.read())
    except OSError:
        files.append(None)
    cap = capsys.readouterr()
    return files, cap.out, cap.err


def test_partial_then_complete_identical(tmp_path, capsys):
    want = _run(jax_emit, str(tmp_path / "jax.json"), capsys)
    got = _run(bench_emit, str(tmp_path / "port.json"), capsys)
    assert got == want
    files, out, err = got
    assert err == ""
    lines = out.strip().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[0])["complete"] is False
    assert json.loads(lines[1])["value"] == 11.3
    # the file is rewritten on every emit
    assert json.loads(files[0])["detail"] == {"ar_tokens_per_s": 35.2}
    full = json.loads(files[1])
    assert full["complete"] is True
    assert full["detail"]["phase_4_seconds"] == 71.25


def test_unwritable_detail_path_keeps_going(tmp_path, capsys):
    """A detail path in a missing directory: the message goes to stderr,
    the compact lines still go out, as the reference's do."""
    want = _run(jax_emit, str(tmp_path / "missing" / "d.json"), capsys)
    got = _run(bench_emit, str(tmp_path / "missing" / "d.json"), capsys)
    assert got == want
    files, out, err = got
    assert files == [None, None]
    assert err.count("bench_detail write failed:") == 2
    assert len(out.strip().splitlines()) == 2
