"""Device seconds of the agent-engine layer in the traced study: the
union of the device events of the ``hlo_module``s that
``layers/agents.json`` names (chunks, tail, compaction, flush, prologue
and weight-table builds)."""


def read(ctx):
    return ctx.trace['layer_s'].get('agents')
