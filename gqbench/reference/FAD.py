"""FAD: for the documents that hold both t1 and t2, Σ Fre of every term
they hold, by term."""


def run(g, params, dtype, work=None):
    in1 = g.hop(g.seed("Term", params["t1"], dtype), "DT", "Term", work=work) != 0
    in2 = g.hop(g.seed("Term", params["t2"], dtype), "DT", "Term", work=work) != 0
    return g.hop((in1 & in2).to(dtype), "DT", "Doc", measure="Fre", work=work)
