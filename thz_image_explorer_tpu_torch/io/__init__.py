"""Host I/O: dotTHz (HDF5) files, the in-memory scan open, and the PSF
``.npz`` codec."""
