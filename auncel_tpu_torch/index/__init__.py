"""IVF index layouts and scans."""
