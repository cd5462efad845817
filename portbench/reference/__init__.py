"""The plain reference (``pca64``) and the comparison (``judge``)."""
