"""A frozen copy of the Draco host encoder (draco-oxide's bitstream, Draco
v2.2, Edgebreaker Standard), cut to the parts that encoding a triangle
mesh with POSITION, NORMAL and TEX_COORD reaches, in numpy and Python only,
with no native library. It is the benchmark's plain reference; nothing in
it imports the program under test."""
