"""The benchmark's own machinery: finding a cell's files by name, making
its traffic from the seed, timing the window, reading the profiler's
trace and comparing what the timed path produced with the plain
reference. Nothing here imports the program at module level."""
