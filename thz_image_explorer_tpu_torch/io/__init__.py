"""Host I/O: dotTHz (HDF5) files and the in-memory scan open."""
