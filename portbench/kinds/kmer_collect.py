"""Traffic kind ``kmer_collect``: the whole k-mer table of a loaded
chromosome, gathered to the host, one action after another.

Set-up makes the chromosome from the seed, writes it as FASTA under
``TMPDIR`` and ingests it once into the configuration's logical shards.
Each action is ``MaRe(ds).map(image="kmer-stats", k=k)
.reduce_by_key(key, value_by=count, op="sum").collect()``: the map, the
exchange, the keyed fold and the gather of every distinct key.  Nothing
is persisted, so every action runs its whole plan.

``control`` gives the control of the comparison (``portbench/
controls.py``).

Parameters (the traffic file): ``k``; ``warmup_actions``;
``trace_actions`` (actions under the profiler with ``--trace 1``);
``samples`` (answers kept, drawn from the seed, besides the last).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from portbench.data import genome
from portbench.reference import kmer as reference


def kmer_key(r):
    return r[0]


def kmer_count(r):
    return (r[1],)


class Session:
    #: Stages an action may take from the materialization cache.
    cached_stages = 0

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core import MaRe
        from repro_torch.io import fasta_source
        self.config, self.k = config, int(traffic["k"])
        self.seq = genome.make_genome(config["bases"], seed,
                                      config["n_fraction"],
                                      config["softmask_fraction"])
        with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
            path = os.path.join(tmp, "genome.fa")
            genome.write_fasta(path, self.seq, config["line"])
            self.ds = MaRe.from_source(
                fasta_source(path), num_shards=config["num_shards"],
                device=device).dataset
        self.mare = MaRe

    def action(self):
        m = (self.mare(self.ds).map(image="kmer-stats", k=self.k)
             .reduce_by_key(kmer_key, value_by=kmer_count, op="sum"))
        return m.collect(), m.report()

    def free(self) -> None:
        self.ds = None

    def check(self, answers: list) -> tuple:
        """(worst value of each compared number over ``answers``, the
        fold's work) against the reference table."""
        table = reference.kmer_bincount(self.seq, self.k,
                                        self.config["line"])
        worst: dict = {}
        for answer in answers:
            for name, value in reference.compare(answer, table).items():
                worst[name] = max(worst.get(name, value), value)
        return ({name: (value, 0) for name, value in worst.items()},
                reference.work(table))


def setup(config: dict, traffic: dict, seed: int, device) -> Session:
    return Session(config, traffic, seed, device)


def control(session: Session, actions: int) -> list:
    """The control's answer: the reference put in the program's place with
    one guarantee broken (soft-masked windows left out), in the answer's
    form.  The comparison has to find it wrong."""
    table = reference.kmer_bincount(session.seq, session.k,
                                    session.config["line"], fold_case=False)
    keys = np.flatnonzero(table).astype(np.int32)
    occ = table[keys].astype(np.int32)
    return [(keys, (occ,), occ.copy())]
