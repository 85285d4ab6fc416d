"""chip_smoke.py at tiny sizes on the CPU: every phase runs its public-API
path and passes its own checks; main() refuses to report without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def smoke():
    s = cs.Smoke('test', reps=1)
    yield s
    assert s.failed == []


@pytest.mark.parametrize('phase,kwargs', [
    (cs.phase_fft_convolve, dict(n=2**12, taps=65)),
    (cs.phase_fft_family, dict(n=2**12, n_c128=2**10, batch=32,
                               sweep=(8, 12))),
    (cs.phase_elementwise, dict(shape=(32, 64))),
    (cs.phase_models, dict(batch=2, n_stft=2**13, n_sos=2**12)),
    (cs.phase_compile, dict(n=2**11, taps=65)),
    (cs.phase_findings, dict(n=2**12, shape=(32, 64))),
], ids=['convolve', 'fft_family', 'elementwise', 'models', 'compile',
        'findings'])
def test_phase_small(smoke, phase, kwargs, capsys, tmp_path):
    if phase is cs.phase_models:
        kwargs = {**kwargs, 'trace_file': str(tmp_path / 'stft.json')}
    phase(smoke, **kwargs)
    out = capsys.readouterr().out
    assert 'check ' in out and 'time ' in out and '[test]' in out


def test_multi_phase_on_virtual_devices(smoke):
    # the --multi path on 4 of the 8 virtual CPU devices
    cs.phase_multi(smoke, count=4, n=2**12, batch=8, n_conv=2**10, taps=65)


def test_check_and_phase_record_failures(capsys):
    s = cs.Smoke('test', reps=1)
    assert not s.check('too big', 1.0, 1e-5, 'float32')
    assert not s.check('nan', float('nan'), 1e-5, 'float32')

    def boom(_):
        raise ValueError('phase broke')

    cs._phase(s, 'boom', boom)
    assert s.failed == ['too big', 'nan', 'boom']
    assert 'FAIL' in capsys.readouterr().out


@pytest.mark.parametrize('cards,want', [
    (['H, 700.00 W'], 'H, 700.00 W'),
    (['H, 700.00 W'] * 4, '4 x H, 700.00 W'),
    (['H, 700.00 W', 'H, 500.00 W'], 'H, 700.00 W; H, 500.00 W'),
])
def test_card_label(cards, want):
    assert cs.card_label(cards) == want


def test_main_fails_without_gpu(capsys):
    assert cs.main([]) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)['ok'] is False


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, 'PYTHONPATH': ''})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
