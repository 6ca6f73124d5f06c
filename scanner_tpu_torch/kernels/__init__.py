# Importing registers the stdlib ops (like `import scannertools.imgproc`
# in the reference tutorials).  Only imgproc.Histogram and shot are
# ported so far.
from . import imgproc, shot  # noqa: F401
