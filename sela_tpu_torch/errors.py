"""Shared exception types.

ContainerError is the single failure mode for malformed `.sela` input: every
decode path (numpy oracle, streaming, port decoder, native C++ scanner)
raises it — never IndexError/struct.error — so callers can catch one type
(capability parity with the reference's data::Exception hierarchy,
upstream:include/data/exception.hpp, path-level cite — mount empty,
SURVEY.md §2 "Data structs").

Lives outside the ref package to break the import cycle ref.frame ↔
ref.container (frame-level validation raises it too).
"""


class ContainerError(ValueError):
    pass
