"""The sinkhorn kernel's share of its roofline in the traced stretch, in %
(roofline/__init__.share with roofline/sinkhorn.py)."""

from benchmark.roofline import share


def read(ctx, name):
    return share(ctx, "sinkhorn")
