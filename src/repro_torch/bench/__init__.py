"""Scripts that measure or check the port end to end: the chunking
localiser and the port's copy of Table IX's trace arm."""
