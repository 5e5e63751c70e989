"""Host I/O: dotTHz (HDF5) files, the in-memory scan open, the PSF
``.npz`` codec and the VTU export of the 3-D view."""
