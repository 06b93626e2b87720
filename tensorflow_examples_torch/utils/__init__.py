"""Host-side utilities: fault injection and failure diagnostics."""
