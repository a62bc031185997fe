"""The comparison that decides ``correct`` catches a broken timed path.

Each case drives a whole run of a cell on the CPU, in a process of its
own (the harness's look for a card skipped, every other step as on the
card), with one fault planted in the program underneath, and sees
``correct`` come out false:

- ``half``: half of each shard's records left out of every action;
- ``no_exchange``: every shard's records sent to itself, as if the
  exchange between shards were left out;
- ``altered``: one value of the answer changed where it is produced.

A run keeps no state from one action to the next, so the fault of a step
that returns its state unchanged has nothing to act on here.
"""
import pytest

from portbench.tests.test_portbench_harness import SMALL, cpu_runs


def plant(monkeypatch, fault: str) -> None:
    """Break the program underneath a run (in the run's own process)."""
    import torch
    from repro_torch.core import mare, planner
    from repro_torch.runtime import executor
    if fault == "half":
        execute = executor.execute

        def halved(ds, plan, **kw):
            return execute(ds.with_records(ds.records, ds.counts // 2),
                           plan, **kw)
        monkeypatch.setattr(executor, "execute", halved)
    elif fault == "no_exchange":
        shuffle = planner.shuffle_partition

        def to_itself(parts, keys, *a, **kw):
            kw["dests"] = [torch.full_like(k, s, dtype=torch.int32)
                           for s, k in enumerate(keys)]
            return shuffle(parts, keys, *a, **kw)
        monkeypatch.setattr(planner, "shuffle_partition", to_itself)
    else:
        finalizer = mare._finalizer

        def altering(shard):
            fn = finalizer(shard)

            def collect(ds):
                out = fn(ds)
                # the k-mer answer's occurrences, or the SNP scores
                leaf = out[1][0] if isinstance(out[1], tuple) else out[1]
                leaf[0] += 1
                return out
            return collect
        monkeypatch.setattr(mare, "_finalizer", altering)


FAULTS = ("half", "no_exchange", "altered")


@pytest.fixture(scope="module")
def lines():
    """Every cell once sound and once with each fault, on the CPU."""
    jobs = [(cell, False, fault) for cell in sorted(SMALL)
            for fault in (None,) + FAULTS]
    return {(cell, fault): line
            for (cell, _, fault), line in zip(jobs, cpu_runs(jobs))}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(lines, cell, fault):
    line = lines[cell, fault]
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(lines, cell):
    line = lines[cell, None]
    assert line["correct"] is True, line["checks"]
