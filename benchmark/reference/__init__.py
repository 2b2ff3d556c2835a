"""The plain reference: a frozen decode of the quad words and a plain
PyTorch IHT.  It imports nothing of the program."""
