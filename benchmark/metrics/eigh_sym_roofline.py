"""The eigh_sym kernel's share of its roofline in the traced stretch, in %
(roofline/__init__.share with roofline/eigh_sym.py)."""

from benchmark.roofline import share


def read(ctx, name):
    return share(ctx, "eigh_sym")
