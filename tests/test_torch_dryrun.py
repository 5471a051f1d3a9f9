"""``parallel/dryrun.py:dryrun_multiprocess`` on 2 gloo ranks on the CPU:
the cohort step, the data-parallel and padded fits, the tensor-parallel fit,
the RAMS trainer's batch data parallelism and the sharded
``fit_ensemble_batched``, ``fit_alternating_pn`` and ``fit_until``, each
held to one rank within the JAX dry run's rtol 1e-4; and a failing rank
failing the run."""
import pytest

from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks
from mri_super_resolution_tpu_torch.parallel.dryrun import dryrun_multiprocess


def test_dryrun_on_two_cpu_ranks(capsys):
    results = dryrun_multiprocess(2, "cpu", timeout=300)
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert max(r[k] for k in ("dp", "padded", "tp", "trainer")) <= 1e-4
        assert max(r[k] for k in ("ensemble", "alternating", "until")) <= 1e-4
        assert r["until_steps"] == results[0]["until_steps"]
    out = capsys.readouterr().out
    assert "dryrun_multiprocess OK: 2 ranks on cpu" in out
    assert "sharded fit_ensemble/fit_alternating_pn/fit_until" in out


def _fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()  # rank 0 waits for a rank that never comes
    return 0


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        spawn_ranks(_fail_on_rank_one, 2, timeout=120)
