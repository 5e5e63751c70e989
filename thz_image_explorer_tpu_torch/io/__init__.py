"""Host I/O: dotTHz (HDF5) files and their metadata, the in-memory scan
open, the PSF ``.npz`` codec, the VTU export of the 3-D view and the
sibling-file listing."""
