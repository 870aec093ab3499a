"""From handing the CsrGraph to the program until its first call
returns: the program's host set-up (relabel, transpose, symmetry,
components, uploads, kernel loads) and that call's two searches."""


def read(rec):
    return rec.setup["first_call_s"]
