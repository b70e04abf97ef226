"""The port's name-resolve store (areal_tpu_torch/base/name_resolve.py) and
key schema (base/names.py) against the reference's (areal_tpu/base): the
twins of tests/test_base.py's TestNameResolve, and one NFS directory that
both packages write and read."""

import threading
import time

import pytest

from areal_tpu.base import name_resolve as jnr
from areal_tpu.base import names as jnames
from areal_tpu_torch.base import name_resolve, names, network


@pytest.mark.parametrize("repo_cls", ["memory", "nfs"])
def test_basic(repo_cls, tmp_path):
    if repo_cls == "memory":
        repo = name_resolve.MemoryNameRecordRepo()
    else:
        repo = name_resolve.NfsNameRecordRepo(str(tmp_path))
    repo.add("a/b/c", "v1")
    assert repo.get("a/b/c") == "v1"
    with pytest.raises(name_resolve.NameEntryExistsError):
        repo.add("a/b/c", "v2")
    repo.add("a/b/c", "v2", replace=True)
    assert repo.get("a/b/c") == "v2"
    repo.add("a/b/d", "v3")
    assert repo.find_subtree("a/b") == ["a/b/c", "a/b/d"]
    assert sorted(repo.get_subtree("a/b")) == ["v2", "v3"]
    repo.delete("a/b/c")
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        repo.get("a/b/c")
    repo.clear_subtree("a")
    assert repo.find_subtree("a") == []


def test_wait(tmp_path):
    repo = name_resolve.NfsNameRecordRepo(str(tmp_path))

    def _add():
        time.sleep(0.2)
        repo.add("x/y", "late")

    t = threading.Thread(target=_add, daemon=True)
    t.start()
    assert repo.wait("x/y", timeout=5) == "late"
    t.join(timeout=5)
    assert not t.is_alive()
    with pytest.raises(TimeoutError):
        repo.wait("x/never", timeout=0.2)


def test_subentry(tmp_path):
    repo = name_resolve.NfsNameRecordRepo(str(tmp_path))
    k1 = repo.add_subentry("servers", "url1")
    k2 = repo.add_subentry("servers", "url2")
    assert k1 != k2
    assert sorted(repo.get_subtree("servers")) == ["url1", "url2"]


@pytest.mark.parametrize("repo_cls", ["memory", "nfs"])
def test_keepalive_lease_expires(repo_cls, tmp_path):
    repo = (name_resolve.MemoryNameRecordRepo() if repo_cls == "memory"
            else name_resolve.NfsNameRecordRepo(str(tmp_path)))
    repo.add("w/hb", "alive", keepalive_ttl=0.3)
    repo.touch("w/hb")
    assert repo.get("w/hb") == "alive"
    time.sleep(0.5)
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        repo.get("w/hb")
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        repo.touch("w/hb")
    repo.add("w/hb", "again")  # an expired lease does not block re-adding
    assert repo.get("w/hb") == "again"


def test_nfs_delete_prunes_up_to_a_root_given_with_a_slash(tmp_path):
    """Deleting the last key removes its empty directories up to the root,
    and never the root or what lies above it, however the root is
    spelled."""
    root = tmp_path / "nr"
    repo = name_resolve.NfsNameRecordRepo(str(root) + "/")
    repo.add("a/b/c", "v")
    repo.delete("a/b/c")
    assert root.is_dir() and list(root.iterdir()) == []
    assert tmp_path.is_dir()


def test_one_directory_for_both_packages(tmp_path):
    """Keys the port writes read in the reference, and the reference's in
    the port, through the same NFS root — leases and deletes included."""
    root = str(tmp_path / "nr")
    port = name_resolve.NfsNameRecordRepo(root)
    ref = jnr.NfsNameRecordRepo(root)
    key = names.weight_stream("exp", "t0", "actor")
    assert key == jnames.weight_stream("exp", "t0", "actor")
    port.add(key, "tcp://10.0.0.1:5555")
    assert ref.get(key) == "tcp://10.0.0.1:5555"
    vkey = jnames.model_version("exp", "t0", "actor")
    assert vkey == names.model_version("exp", "t0", "actor")
    ref.add(vkey, "7", keepalive_ttl=30)
    assert port.get(vkey) == "7"
    assert port.find_subtree(names.trial_root("exp", "t0")) == \
        ref.find_subtree(jnames.trial_root("exp", "t0")) == sorted([key, vkey])
    ref.delete(key)
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        port.get(key)
    port.delete(vkey)
    with pytest.raises(jnr.NameEntryNotFoundError):
        ref.get(vkey)


def test_module_functions_and_reconfigure(tmp_path):
    old = name_resolve.DEFAULT_REPO
    try:
        name_resolve.reconfigure(name_resolve.NameResolveConfig(type="memory"))
        assert isinstance(name_resolve.DEFAULT_REPO,
                          name_resolve.MemoryNameRecordRepo)
        name_resolve.add("k/1", "a")
        assert name_resolve.get("k/1") == "a"
        assert name_resolve.wait("k/1", timeout=1) == "a"
        name_resolve.reconfigure(name_resolve.NameResolveConfig(
            type="nfs", nfs_record_root=str(tmp_path)))
        name_resolve.add("k/2", "b")
        assert jnr.NfsNameRecordRepo(str(tmp_path)).get("k/2") == "b"
        with pytest.raises(NotImplementedError):
            name_resolve.reconfigure(
                name_resolve.NameResolveConfig(type="etcd3"))
    finally:
        name_resolve.DEFAULT_REPO = old


def test_key_schema_matches_the_reference():
    """Every key builder of the reference's names.py exists in the port and
    builds the same key."""
    fns = [n for n in dir(jnames) if callable(getattr(jnames, n))
           and not n.startswith("_")]
    assert len(fns) > 30
    for n in fns:
        fn, jfn = getattr(names, n), getattr(jnames, n)
        args = ["exp", "trial", "x", "y"][:jfn.__code__.co_argcount]
        assert fn(*args) == jfn(*args), n


def test_network_helpers():
    host, port = network.parse_tcp(network.advertised_tcp(1234))
    assert port == 1234 and host.count(".") == 3
    port = network.find_free_port()
    assert 0 < port < 65536
    with pytest.raises(ValueError):
        network.parse_tcp("http://localhost:1")
