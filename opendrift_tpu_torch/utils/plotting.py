"""matplotlib on demand, for the port's plots.

matplotlib is not installed on every machine the port runs on (the card
machines lack it).  No module of the port imports it at module level: each
plot calls :func:`pyplot` (or :func:`animation`) when it runs, and where
matplotlib is missing that raises an ``ImportError`` that names it.
"""


def _missing(e):
    return ImportError("the port's plots draw with matplotlib, which is "
                       f"not installed ({e})")


def pyplot():
    """``matplotlib.pyplot``, or an ``ImportError`` naming matplotlib."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise _missing(e) from e
    return plt


def animation():
    """``matplotlib.animation``, or an ``ImportError`` naming
    matplotlib."""
    try:
        from matplotlib import animation as manim
    except ImportError as e:
        raise _missing(e) from e
    return manim


def colormap(name):
    """The matplotlib colormap ``name``, or an ``ImportError`` naming
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise _missing(e) from e
    return matplotlib.colormaps[name]


def use_agg():
    """Select the Agg backend unless one was chosen already (headless
    figures), as the JAX package's map plots do."""
    try:
        import matplotlib
    except ImportError as e:
        raise _missing(e) from e
    matplotlib.use("Agg", force=False)
