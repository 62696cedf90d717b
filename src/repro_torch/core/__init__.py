"""Co-scheduling measurements of the port (the simulator itself stays
framework-free in the reference and is not part of this slice)."""
