# Importing registers the stdlib ops (like `import scannertools.imgproc`
# in the reference tutorials).
from . import image, imgproc, shot  # noqa: F401
