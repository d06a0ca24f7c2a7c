"""Planted faults, one module per generator: ``faults/<generator module>.py``
exports ``FAULTS``, functions that each take a pytest ``monkeypatch`` and
break the timed path underneath the program's entry point.  The cell
tests plant every fault of a cell's generator and see ``correct`` come
out false."""
