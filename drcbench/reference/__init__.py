"""The benchmark's plain reference: a frozen copy of the Draco host codec
(``codec/``), the oracle over it, and its worker pool. It imports nothing of
the program under test."""
