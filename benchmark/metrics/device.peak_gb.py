"""Peak device memory in use after the traced study, in GB (10^9 bytes),
from the runtime's ``peak_bytes_in_use``."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 1e9
