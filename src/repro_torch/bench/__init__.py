"""Scripts that measure or check the port end to end: the chunking
localiser and the port's copies of the trace arms of Tables VIII, IX and
XI."""
