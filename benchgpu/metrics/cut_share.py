"""Share of the window's reads (pairs), in %, whose records the program's
shared record buffer cut (`rec_slots` x rows records all used): counted by
the harness from each drained batch's record counts and outcome flags."""


def read(run):
    return run.cut_share
