"""The plain reference: plain torch and numpy, independent of the program.
It imports nothing of the port and takes nothing the port made: it works
out the graph, features, windows, masks and state again from the
benchmark's inputs (`portbench/inputs.py`)."""
