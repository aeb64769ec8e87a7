"""Plain PyTorch references the program is held against; nothing here imports the program."""
