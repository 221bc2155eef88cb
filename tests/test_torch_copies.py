"""The port's copies of halo2tpu's host modules are copies: once import
statements and docstrings are removed, each parses to the same syntax tree
as its original (comments are not in the tree)."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    # the composite Aadhaar circuit and its gadgets
    "ops/poseidon.py", "gadgets/poseidon.py", "circuits/nullifier.py",
    "circuits/conditional_secrets.py", "gadgets/qr_extractor.py",
    "circuits/aadhaar_qr.py",
    # the gadgets and circuits copied before them
    "gadgets/flexgate.py", "gadgets/range.py", "gadgets/biguint.py",
    "gadgets/rsa.py", "gadgets/sha256.py", "circuits/signal.py",
    "circuits/timestamp.py", "circuits/rsa_sha256.py",
    # the EVM verifier
    "evm/yul.py", "evm/verifier.py",
]


class _Strip(ast.NodeTransformer):
    """Drops import statements and the docstring of every module, class
    and function."""

    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None

    def generic_visit(self, node):
        super().generic_visit(node)
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node


def _tree(path: str) -> str:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return ast.dump(_Strip().visit(tree))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_halo2tpu_without_imports_and_docstrings(rel):
    port = _tree(os.path.join(ROOT, "halo2tpu_torch", rel))
    assert port == _tree(os.path.join(ROOT, "halo2tpu", rel))


def test_the_composite_copies_import_only_the_port():
    for rel in COPIES[:6]:
        with open(os.path.join(ROOT, "halo2tpu_torch", rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level > 0 or node.module in (
                    "__future__", "dataclasses", "functools"), (rel,
                                                                node.module)
            assert not isinstance(node, ast.Import), rel
