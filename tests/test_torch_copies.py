"""The port's copies of halo2tpu's host modules are copies: once import
statements and docstrings are removed, each parses to the same syntax tree
as its original (comments are not in the tree).  The functions named in
REDESIGNED are the exception: their bodies are the port's own (they place
regions through gadgets/placement.py and read its constant tables), so
only their bodies are left out of the comparison, in both trees, and each
must still differ from halo2tpu's."""
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

# file -> the port's own functions: the least-filled search on
# placement.LeastFilled, the placement counter in the occupancy reports,
# the SHA packing's and the extractor's constants from placement's tables,
# the SHA hash path's runs and regions written by word (gadgets/sha_words.py)
REDESIGNED = {
    "gadgets/flexgate.py": ["GateChip.__init__", "GateChip.assign_region",
                            "GateChip.inner_product"],
    "gadgets/range.py": ["RangeChip.__init__", "RangeChip._lookup_cell",
                         "RangeChip.finalize"],
    "gadgets/sha256.py": ["Sha256Chip.__init__", "Sha256Chip._lane_rows",
                          "Sha256Chip._pack_sum", "Sha256Chip.occupancy",
                          "Sha256Chip._load_state_words",
                          "Sha256Chip.compress_block", "Sha256Chip.digest",
                          "Sha256Chip.digest_dynamic"],
    "gadgets/qr_extractor.py": ["ExtractorChip.load_data"],
}


class _Strip(ast.NodeTransformer):
    """Drops import statements and the docstring of every module, class
    and function, and the body of each function named in `redesigned`
    ("Class.function")."""

    def __init__(self, redesigned=()):
        self.redesigned = set(redesigned)
        self.classes = []

    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None

    def visit_ClassDef(self, node):
        self.classes.append(node.name)
        try:
            return self.generic_visit(node)
        finally:
            self.classes.pop()

    def visit_FunctionDef(self, node):
        node = self.generic_visit(node)
        if ".".join(self.classes + [node.name]) in self.redesigned:
            node.body = [ast.Pass()]
        return node

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


def _parse(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), path)


def _tree(path: str, redesigned=()) -> str:
    return ast.dump(_Strip(redesigned).visit(_parse(path)))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_halo2tpu_without_imports_and_docstrings(rel):
    own = REDESIGNED.get(rel, ())
    port = _tree(os.path.join(ROOT, "halo2tpu_torch", rel), own)
    assert port == _tree(os.path.join(ROOT, "halo2tpu", rel), own)


def _function(path: str, qualname: str) -> str:
    """The function's syntax tree without docstrings."""
    cls, name = qualname.split(".")
    tree = _Strip().visit(_parse(path))
    node = next(c for c in tree.body
                if isinstance(c, ast.ClassDef) and c.name == cls)
    return ast.dump(next(f for f in node.body
                         if isinstance(f, ast.FunctionDef) and f.name == name))


@pytest.mark.parametrize("rel,qualname", [
    (rel, q) for rel, names in REDESIGNED.items() for q in names])
def test_each_redesigned_function_differs_from_halo2tpu(rel, qualname):
    """A function listed in REDESIGNED that equals halo2tpu's again is
    taken off the list, so that the copy test compares its body."""
    assert rel in COPIES
    port = _function(os.path.join(ROOT, "halo2tpu_torch", rel), qualname)
    assert port != _function(os.path.join(ROOT, "halo2tpu", rel), qualname)


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
