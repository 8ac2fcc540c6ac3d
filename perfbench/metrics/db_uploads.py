"""Uploads of the DB's rows (ops.backend.flat_rows): the program's
upload.rows spans a step."""
from ._spans import spans, named


def read(rec):
    found = spans(rec, named("upload.rows"))
    return len(found) / rec.steps if found else None
