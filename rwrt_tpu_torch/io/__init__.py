"""Host-side IO: wind ingest and the basic-state, trajectory and
wavenumber-map files (``ncio``)."""
