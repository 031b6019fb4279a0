"""The CLI's reports (the program span `quantify.reports`: the last
image files, the pools' shutdown, the summary CSVs and workbook), ms per
CLI call (`quantify.call`)."""

from harness.program_trace import per_unit


def read(view):
    return per_unit(view, "quantify.reports", "quantify.call")
