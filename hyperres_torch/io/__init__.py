"""Host I/O (HDF5 granules, ENVI, GeoTIFF, XML sidecars) and the
streamed band-chunk ingest to the device."""
