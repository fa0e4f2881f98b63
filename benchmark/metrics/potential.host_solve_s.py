"""Host wall seconds inside the program's potential-solve calls in the
traced study, timed by the harness around each call. For the float64
direct solve this is the whole solve; for the device solver it is only
the host prep and the dispatch (the device work runs after the call
returns), so read it with the cell's configuration in mind."""


def read(ctx):
    return float(sum(ctx.solve_seconds)) if ctx.solve_seconds else None
