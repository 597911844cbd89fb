"""The work of guided-diffusion's ADM from a configuration's shapes (the
flags of ``configs/adm256_uncond.json``): a forward's model operations by
compute dtype, as ``torch.utils.flop_counter`` counts the plain reference
(2 per multiply-add; norms, resampling and elementwise work not counted),
and K2's calls, each with its bytes and operations at d =
``num_head_channels`` (``work.attention``, the frozen copy of
``ops/attention.py::work``).

In a net served in bf16 only the last 3x3 conv (``out.2``) stays fp32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.lib import work


def _conv(b, s, cin, cout, k):
    return 2 * b * s * s * cin * cout * k * k


def _walk(config: dict, image: int):
    """(kind, spatial size, channels in, channels out) of each block of the
    forward in order: ``res`` (a ResBlock: its convs run at the output
    size), ``attn`` (an AttentionBlock of ``cin`` channels)."""
    mc, mults = config["num_channels"], config["channel_mult"]
    nrb = config["num_res_blocks"]
    attn_ds = {image // r for r in config["attention_resolutions"]}
    out, ch, ds, skips = [], mc * mults[0], 1, []
    skips.append(ch)
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            out.append(("res", image // ds, ch, mult * mc))
            ch = mult * mc
            if ds in attn_ds:
                out.append(("attn", image // ds, ch, ch))
            skips.append(ch)
        if level != len(mults) - 1:
            ds *= 2
            out.append(("res", image // ds, ch, ch))
            skips.append(ch)
    out += [("res", image // ds, ch, ch), ("attn", image // ds, ch, ch),
            ("res", image // ds, ch, ch)]
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            out.append(("res", image // ds, ch + skips.pop(), mult * mc))
            ch = mult * mc
            if ds in attn_ds:
                out.append(("attn", image // ds, ch, ch))
            if level and i == nrb:
                ds //= 2
                out.append(("res", image // ds, ch, ch))
    return out, ch


def forward_flops(config: dict, batch: int, image: int) -> Dict[str, int]:
    """Operations of one forward at ``batch`` images of ``image``^2, by
    compute dtype."""
    b, mc = batch, config["num_channels"]
    emb = 4 * mc
    cin = config["in_channels"]
    cout = config["out_channels"]
    blocks, last = _walk(config, image)
    total = 2 * b * (mc * emb + emb * emb)  # time_embed
    total += _conv(b, image, cin, mc * config["channel_mult"][0], 3)
    for kind, s, ci, co in blocks:
        if kind == "res":
            total += _conv(b, s, ci, co, 3) + _conv(b, s, co, co, 3)
            total += 2 * b * emb * 2 * co  # emb_layers
            if ci != co:
                total += _conv(b, s, ci, co, 1)
        else:
            n = s * s
            total += 2 * b * n * ci * 4 * ci  # qkv and proj_out
            total += 2 * 2 * b * n * n * ci  # q k^T and p v over the heads
    final = _conv(b, image, last, cout, 3)
    if config["compute_dtype"] == "bf16":
        return {"bf16": total, "fp32": final}
    return {"bf16": 0, "fp32": total + final}


def k2_calls(config: dict, image: int) -> List[Tuple[int, int, int]]:
    """(n, heads, d) of each attention block's K2 call in a forward."""
    d = config["num_head_channels"]
    blocks, _ = _walk(config, image)
    return [(s * s, c // d, d) for kind, s, c, _ in blocks if kind == "attn"]


def k2_call(b: int, n: int, h: int, d: int) -> dict:
    """Bytes and operations of one bf16 K2 call."""
    return work.attention(b, n, h, d, 2)
