"""The train step's share of the cards' bf16 peak, in %: the forward and
backward FLOPs of the window's steps over the window's length times the
cards times 989 TFLOP/s (the power limit is printed beside the run).

A step over B rows of T + 1 positions (the start embedding and the fed
tokens; the training forward's padding of them to the 49 encoder rows
is not counted): per position and layer the fused q/k/v and output
projections, the cross query and output projections, the feed-forward
pair, self-attention over the positions before it and cross-attention
over the 49 rows; the classifier; per row and layer the cross keys and
values of the 49 rows; the head's linear over the pooled and the 49
spatial rows. The backward is twice the forward, but the head's, which
takes no input gradient (its features are frozen), is once.
"""

from perfbench.core import peaks


def step_flops(cfg, traffic):
    d, pf, t_enc = cfg["hid_dim"], cfg["pf_dim"], cfg["encoder_rows"]
    b, pos = traffic["batch"], traffic["caption_tokens"]
    attn = 2 * d * (pos + 1) / 2 * 2  # QK and PV over (pos + 1) / 2 keys
    per_pos = cfg["n_layers"] * (2 * 4 * d * d + 2 * 2 * d * d
                                 + 2 * 2 * d * pf + attn + 2 * 2 * t_enc * d)
    per_pos += 2 * d * cfg["num_tokens"]
    per_row = cfg["n_layers"] * t_enc * 2 * 2 * d * d
    head = (1 + t_enc) * 2 * 2048 * d
    return 3 * b * (pos * per_pos + per_row) + 2 * b * head


def read(ctx):
    tr = ctx.get("summaries")
    if ctx.get("kind") != "train" or not tr:
        return None
    flops = step_flops(ctx["config"], ctx["traffic"]) * ctx["steps"]
    return 100.0 * flops / (ctx["window_s"] * ctx["world"]
                            * peaks.BF16_FLOPS)
