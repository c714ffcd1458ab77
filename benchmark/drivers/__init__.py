"""The general generators that traffic files name under "driver": each
reads a mix's parameters and drives the program's entry points with inputs
drawn from the seed."""
