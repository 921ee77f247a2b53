"""Root pytest hooks that apply to every test directory.

Decoded model text can hold lone surrogates: ``ByteTokenizer.decode``
uses ``surrogateescape`` so that invalid bytes round-trip. When such text
reaches a test report (captured output, a failure message), pytest-xdist
cannot send the report from its worker, because execnet only serializes
strings that encode as UTF-8; the whole pytest run then ends in an
INTERNALERROR. This hook re-encodes report text with
``backslashreplace`` so every report can be sent.
"""

import pytest


def _utf8_safe(text: str) -> str:
    return text.encode("utf-8", "backslashreplace").decode("utf-8")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    report = outcome.get_result()
    report.sections = [
        (_utf8_safe(title), _utf8_safe(body)) for title, body in report.sections
    ]
    if isinstance(report.longrepr, str):
        report.longrepr = _utf8_safe(report.longrepr)
