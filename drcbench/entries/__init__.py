"""One module a program entry, found by the ``entry`` of a traffic mix."""
