"""The agent engine's share of the HBM roofline, in percent: the
algorithmic bytes of the study's useful agent-steps (``roofline.py``, a
lower bound) over the engine's device seconds times the card's published
HBM bandwidth (``peaks.json``). Nothing is returned without an engine
device time or a peak."""


def read(ctx):
    secs = ctx.trace['layer_s'].get('agents')
    if not secs or not ctx.useful_steps or ctx.peaks is None \
            or ctx.bytes_per_agent_step is None:
        return None
    moved = ctx.useful_steps * ctx.bytes_per_agent_step
    return 100. * moved / (secs * ctx.peaks['hbm_bytes_per_s'])
