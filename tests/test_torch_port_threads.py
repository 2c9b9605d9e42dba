"""The port's tests share one CPU thread budget (`tests/torch_threads.py`)."""

import tests.torch_threads  # sets the CPU thread budget

import ast
import os
from pathlib import Path

import pytest
import torch

PORT_TESTS = sorted(Path(__file__).parent.glob("test_torch_port_*.py"))


def _imports(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_test_file_imports_the_thread_budget(path):
    assert "tests.torch_threads" in _imports(path)


def test_thread_budget_holds_in_this_process():
    """torch's intra-op pool has the CPUs this process may run on, shared
    among the xdist workers, at least one."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert tests.torch_threads.budget() == max(1, cores // workers)
    assert torch.get_num_threads() == tests.torch_threads.budget()
