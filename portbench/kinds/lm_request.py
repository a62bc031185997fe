"""Traffic kind ``lm_request``: one greedy LM request after another,
through the port's serving entry points.

Set-up makes the configuration's weights from the seed on the device,
one layer at a time (``data/lm_weights.py``), and loads them into the
port's model (``models.build_model``; the weights' storage is allocated
once, from the model built on the meta device).  Each action is one
request (``launch.serve.greedy_request``: ``model.prefill``, then
``model.decode_step`` through the cache ``prefill`` filled): a fresh
prompt of ``prompt_tokens`` ids drawn uniformly from the whole vocabulary
by a generator of the seed, prefilled, then ``decode_tokens`` greedy
decode steps.  The answer, on the host: the prompt, the generated ids
(the prefill's, then one a step), the float32 logits of the last prompt
position and of each decode step, and the experts each MoE layer chose
for each token (``moe.record_routing``).

``check``, after the port's state is freed: the plain float32 reference
(``reference/jamba.py``) is fed each answer's prompt and its generated
ids but the last, with the weights made again from the seed a layer at a
time, and its logits at the answer's positions are compared with the
answer's (relative RMS error and largest absolute error, each under its
limit); tokens are never compared.  The reference takes the program's
choice of experts where it ties with its own within ``route_margin`` of
a router logit (a near-tie flips on rounding, and a flipped expert moves
a token's output by far more than rounding does); a choice outside the
margin counts in ``routing_wrong``, held to 0, as is the ``moe.dropped``
counter over the session (``moe.flush_dropped``).  The share of rows
whose choice differs from the reference's own (``routing_flip_share``,
in %) is held under its limit, so that a fault which moves choices
inside the margin, where the reference takes them, still shows.

``control`` (``portbench/controls.py``): the same requests, whose logits
``check`` takes from the reference computed below the precision the
configuration states (the traffic's ``control``): ``"fp8"`` rounds both
operands of every matrix product to float8 (e4m3, a scale a tensor), the
type next below the configuration's bfloat16; ``"bf16"`` computes in
bfloat16 with the scan state in bfloat16; ``"state_bf16"`` holds only the
scan state in bfloat16.

Parameters (the traffic file): ``prompt_tokens``; ``decode_tokens``;
``warmup_actions``; ``trace_actions``; ``samples``; ``limits``
(``logits_rel_rms``, ``logits_max_abs``, ``routing_flip_share``);
``route_margin``; ``control``.
"""
from __future__ import annotations

import torch

from portbench.data import lm_weights
from portbench.reference import jamba as reference


#: The reference's arguments for each control (``reference.forward``).
CONTROLS = {
    "fp8": {"matmul_dtype": torch.float8_e4m3fn},
    "bf16": {"dtype": torch.bfloat16, "state_dtype": torch.bfloat16},
    "state_bf16": {"state_dtype": torch.bfloat16},
}


def model_config(c: dict):
    """The port's ``JambaConfig`` of the configuration file ``c`` (the
    published keys).  Raises on a port without the jamba family."""
    from repro_torch.models.common import JambaConfig
    if c.get("mamba_proj_bias") or c.get("hidden_act") != "silu":
        raise ValueError("the port's Mamba mixer takes no projection bias "
                         "and SiLU")
    d, heads = c["hidden_size"], c["num_attention_heads"]
    return JambaConfig(
        name=c["name"], family="jamba", num_layers=c["num_hidden_layers"],
        d_model=d, num_heads=heads, num_kv_heads=c["num_key_value_heads"],
        head_dim=d // heads, d_ff=c["intermediate_size"],
        moe_d_ff=c["intermediate_size"], num_experts=c["num_experts"],
        experts_per_token=c["num_experts_per_tok"],
        vocab_size=c["vocab_size"], ssm_state=c["mamba_d_state"],
        ssm_conv=c["mamba_d_conv"], ssm_expand=c["mamba_expand"],
        ssm_dt_rank=c["mamba_dt_rank"], ssm_conv_bias=c["mamba_conv_bias"],
        attn_layer_period=c["attn_layer_period"],
        attn_layer_offset=c["attn_layer_offset"],
        expert_layer_period=c["expert_layer_period"],
        expert_layer_offset=c["expert_layer_offset"],
        logits_to_keep=c["num_logits_to_keep"],
        tie_embeddings=c["tie_word_embeddings"], norm_eps=c["rms_norm_eps"],
        dtype=c["dtype"], remat=False)


def load(params, config: dict, seed: int, device) -> None:
    """Copy the seeded weights into every parameter of ``params``."""
    named = dict(params.named_parameters())
    done = set()

    def put(prefix, weights):
        for name, t in weights.items():
            named[prefix + name].copy_(t)
            done.add(prefix + name)

    with torch.no_grad():
        put("", lm_weights.outer_weights(config, seed, device,
                                         getattr(torch, config["dtype"])))
        for i in range(config["num_hidden_layers"]):
            put(f"blocks.{i}.", lm_weights.layer_weights(
                config, seed, i, device, getattr(torch, config["dtype"])))
    if done != set(named):
        raise ValueError(f"weights made for {sorted(done ^ set(named))[:4]}"
                         f" do not match the model's")


class Session:
    cached_stages = 0

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.launch.serve import greedy_request
        from repro_torch.models import build_model
        from repro_torch.models.moe import flush_dropped, record_routing
        self.cfg = model_config(config)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = build_model(self.cfg, device=self.device)
        self.params = build_model(self.cfg, device="meta").init(0) \
            .to_empty(device=self.device)
        load(self.params, config, seed, self.device)
        self.prompt_len = int(traffic["prompt_tokens"])
        self.gen = int(traffic["decode_tokens"])
        self.prompts = lm_weights.generator(seed, -2, self.device)
        self.request, self.record_routing = greedy_request, record_routing
        self.moe_layers = sum(
            f == "moe" for _, f in lm_weights.layer_kinds(config))
        self.flush_dropped = flush_dropped
        self.dropped_before = flush_dropped()

    def action(self):
        prompt = torch.randint(0, self.cfg.vocab_size, (1, self.prompt_len),
                               generator=self.prompts, device=self.device)
        with self.record_routing() as routes:
            out = self.request(self.model, self.params, prompt, self.gen)
        answer = {"prompt": prompt[0].to(torch.int32).cpu().numpy(),
                  "ids": out.ids[0].cpu().numpy(),
                  "logits": out.logits[0].cpu().numpy(),
                  "routes": self._by_layer(routes)}
        return answer, out.report

    def _by_layer(self, routes: list):
        """The recorded routing ([tokens, k] a call: the prefill's MoE
        layers, then each decode step's) as [MoE layers, prompt + steps,
        k] int8 on the host, in the reference's token order."""
        m = self.moe_layers
        return torch.stack([torch.cat(routes[j::m]) for j in range(m)]) \
            .to(torch.int8).cpu().numpy()

    def free(self) -> None:
        self.model = self.params = None

    def work(self) -> dict:
        """Each action's scan calls ([b, t, d, n, itemsize, count]: the
        prefill's, then the decode steps') and its decode steps."""
        cfg = self.cfg
        mamba = sum(cfg.layer_kind(i)[0] == "mamba"
                    for i in range(cfg.num_layers))
        di, item = cfg.d_model * cfg.ssm_expand, cfg.param_dtype.itemsize
        return {"ssm_scan": [[1, self.prompt_len, di, cfg.ssm_state, item,
                              mamba],
                             [1, 1, di, cfg.ssm_state, item,
                              mamba * self.gen]],
                "decode_tokens": self.gen}

    def check(self, answers: list) -> tuple:
        """(worst value of each compared number over ``answers``, the
        scan's work) against the reference over the same tokens."""
        cfg, dev = self.config, self.device
        seqs = [torch.from_numpy(a["prompt"]).to(dev).long() for a in answers]
        seqs = [torch.cat([s, torch.from_numpy(a["ids"][:-1]).to(dev)
                           .long()]) for s, a in zip(seqs, answers)]
        positions = range(self.prompt_len - 1, self.prompt_len + self.gen)
        outer = lm_weights.outer_weights(cfg, self.seed, dev,
                                         getattr(torch, cfg["dtype"]))

        def layer(i):
            return lm_weights.layer_weights(cfg, self.seed, i, dev,
                                            getattr(torch, cfg["dtype"]))
        routing = [[torch.from_numpy(r).to(dev) for r in a["routes"]]
                   for a in answers]
        margin = float(self.traffic["route_margin"])
        stats: dict = {}
        want = reference.forward(cfg, outer, layer, seqs, positions,
                                 routing=routing, route_margin=margin,
                                 stats=stats)
        got = [torch.from_numpy(a["logits"]).to(dev) for a in answers
               if a["logits"] is not None]
        if len(got) < len(answers):           # the control's answers
            got = reference.forward(cfg, outer, layer, seqs, positions,
                                    routing=routing, route_margin=margin,
                                    **CONTROLS[self.traffic["control"]])
        limits = self.traffic["limits"]
        checks = {name: (value, limits[name]) for name, value
                  in reference.compare(got, want).items()}
        checks["routing_wrong"] = (stats.get("routing_wrong", 0), 0)
        checks["routing_flip_share"] = (
            100.0 * stats.get("routing_flips", 0)
            / max(1, stats.get("routing_rows", 0)),
            limits["routing_flip_share"])
        checks["moe_dropped"] = (self.flush_dropped()
                                 - self.dropped_before, 0)
        self.routing_stats = stats
        return checks, self.work()


def setup(config: dict, traffic: dict, seed: int, device) -> Session:
    return Session(config, traffic, seed, device)


def control(session: Session, actions: int) -> list:
    """The control's answers: the program's requests, their logits to be
    taken from the reference computed below the configuration's precision
    (the traffic's ``control``).  The comparison has to find them
    wrong."""
    out = []
    for _ in range(actions):
        answer = session.action()[0]
        answer["logits"] = None
        out.append(answer)
    return out
