"""The plain reference the benchmark holds the program against: plain
torch and numpy, nothing of the program."""
