import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Several test workers share the machine's cores."""
    torch.set_num_threads(2)
