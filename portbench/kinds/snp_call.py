"""Traffic kind ``snp_call``: the paper's Listing 3 over reads resident on
the card, one action after another.

Set-up makes the reads on the device from the seed and lays them out as
the configuration's logical shards (shard ``s`` holds reads ``[s * cap,
(s + 1) * cap)``), and registers the user's tools.  Each action is
``map(tools/bwa) -> repartition_by(chromosome) -> map(tools/gatk) ->
reduce(toolbox/concat, depth) -> collect(shard=0)``: the user's maps, the
exchange under skewed keys, gatk's compaction, the concatenating tree
reduce and the gather of the variants.  It launches no kernel of the
port and no keyed fold.

``control`` gives the control of the comparison (``portbench/
controls.py``).

Parameters (the traffic file): ``rounds``; ``depth``; ``warmup_actions``;
``trace_actions``; ``samples``; ``limits.score_err``.
"""
from __future__ import annotations

import torch

from portbench.data import reads as reads_lib
from portbench.reference import snp as reference
from portbench.usertools import snp_tools


class Session:
    cached_stages = 0

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core import MaRe, TextFile
        from repro_torch.core.dataset import ShardedDataset
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        n, shards = config["reads"], config["num_shards"]
        if n % shards:
            raise ValueError(f"{n} reads do not split into {shards} shards")
        snp_tools.register(config["chromosomes"])
        feats, ids = reads_lib.make_reads(n, config["features"], seed,
                                          device)
        counts = torch.full((shards,), n // shards, dtype=torch.int32,
                            device=device)
        self.ds = ShardedDataset(records=(feats, ids), counts=counts,
                                 num_shards=shards)
        self.mare, self.text = MaRe, TextFile

    def action(self):
        m = (self.mare(self.ds)
             .map(input_mount=self.text("/in.fastq"),
                  output_mount=self.text("/out.sam"),
                  image="tools/bwa", rounds=self.traffic["rounds"])
             .repartition_by(snp_tools.chromosome)
             .map(image="tools/gatk")
             .reduce(image="toolbox/concat", depth=self.traffic["depth"]))
        return m.collect(shard=0), m.report()

    def free(self) -> None:
        self.ds = None

    def check(self, answers: list) -> tuple:
        """(worst value of each compared number over ``answers``, no fold
        work) against the reference over the same reads, drawn again from
        the seed."""
        cfg = self.config
        feats, _ = reads_lib.make_reads(cfg["reads"], cfg["features"],
                                        self.seed, self.device)
        feats = feats.cpu().numpy()
        chrom, score = reference.oracle(feats, self.traffic["rounds"],
                                        cfg["chromosomes"])
        del feats
        limits = {"score_err": self.traffic["limits"]["score_err"]}
        worst: dict = {}
        for answer in answers:
            got = reference.compare(answer, chrom, score,
                                    limits["score_err"], cfg["num_shards"])
            for name, value in got.items():
                worst[name] = max(worst.get(name, value), value)
        return ({name: (value, limits.get(name, 0))
                 for name, value in worst.items()}, {})


def setup(config: dict, traffic: dict, seed: int, device) -> Session:
    return Session(config, traffic, seed, device)


def control(session: Session, actions: int) -> list:
    """The control's answers: the same actions with TF32 matrix products
    switched on, the precision next below the float32 the configuration
    states.  The comparison has to find them wrong."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        return [session.action()[0] for _ in range(actions)]
    finally:
        matmul.allow_tf32 = before
