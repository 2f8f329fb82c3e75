"""Op-level exceptions (reference exception_with_row_index.hpp:4-12 /
ExceptionWithRowIndex.java, CastException.java): ANSI-mode errors carry the
first failing row index across the op boundary."""


class ExceptionWithRowIndex(RuntimeError):
    def __init__(self, row_index: int, msg: str = ""):
        super().__init__(msg or f"error at row {row_index}")
        self.row_index = int(row_index)


class CastException(ExceptionWithRowIndex):
    def __init__(self, row_index: int, string_with_error: str = ""):
        super().__init__(row_index,
                         f"Error casting data on row {row_index}: "
                         f"{string_with_error!r}")
        self.string_with_error = string_with_error
