"""The plain reference: answers worked out again from the seed, and the
judge that holds served answers to them. Imports nothing of the program."""
