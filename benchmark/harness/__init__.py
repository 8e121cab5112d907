"""The yardstick's general parts: loading by name, the run, the trace's
arithmetic, spans, the table of peaks."""
