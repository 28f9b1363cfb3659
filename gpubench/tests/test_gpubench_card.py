"""The control at a cell's own size, where CUDA is: one short window of
each cell in ``BENCHMARK.json``, the program within every limit and the
control (the reference in float8, ``calibrate``) beyond at least one."""
import pytest

from gpubench import calibrate, manifest, run


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
def test_control_fails_where_the_program_passes(workload, card):
    run.set_cache_dirs(manifest.ROOT)
    cell = manifest.cell(workload)
    rows, _ = calibrate.readings(cell, [2**31 + 977], 20.0, "cuda")
    limits = cell["config"]["limits"]
    program, control = rows[0]["program"], rows[0]["control"]
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits if k in control), control
