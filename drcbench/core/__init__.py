"""The benchmark's yardstick: inputs, the closed-loop window, the trace's
reduction, the counts of work and the table of peaks."""
