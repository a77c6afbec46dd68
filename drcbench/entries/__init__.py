"""One module a program entry, found by the ``entry`` of a traffic mix. It
defines ``Entry(config, traffic, device)`` with ``prepare(takes)``, which
turns a request's takes, a list of ``(faces, [(positions, normals, uvs),
...])``, into what ``run`` takes; ``run(request)``, which returns one
``.drc`` a frame, in the takes' and frames' order; and ``timings()``, the
last run's stage seconds."""
