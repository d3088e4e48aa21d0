"""The benchmark's frozen yardsticks: input streams, the lane kernel's work
count, the card's peaks and the reading of a profiler trace. Copies, so
that a change to the program cannot move them."""
