"""Scripts that measure or check the port end to end: the chunking
localiser, the port's copies of the trace arms of Tables VIII, IX, XI and
XIII, and Table XII's region arm."""
