"""The benchmark of ``thz_image_explorer_tpu_torch``: see ``README.md``."""
