"""The benchmark's frozen copies against their sources at the commit they
were taken from (6d463e6b506c).

Each copy holds pieces of a source as they were then: a module-level
function, class or constant, or a member of a class, from its first
decorator through its last line.  A piece is its source's text byte for
byte, or, where the source routes through the program's native library,
that text with the native route taken out (a ``try`` block importing
``native``) and its docstring free.  The hashes below are of the pieces
at that commit, so these tests keep holding when the program's files
change later: the yardstick stays frozen, and a copy edited by hand
fails.  Where a source still holds its piece as it was, the piece's
derivation is checked again."""

import ast
import hashlib
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# copy -> (source, {piece: sha256 of the source's piece at the commit, or
# (that, sha256 of the copy's piece) where the native route was taken out})
PIECES = {
    "frozen/corpus.py": ("tokenmonster_tpu_torch/corpus.py", {
        "single_byte_values": "a9d80cf2717f2e29c8b67f41bed064e486ef04018971e7182f21d8c25d7cedbe",
        "stdlib_text": "c1aead78e29b2010dbe8d00cf3775a751f40945ad8ff0fad011db66f5148e72f",
    }),
    "frozen/fnv.py": ("chip_smoke.py", {
        "fnv1a64": "7ee6da84c71274b49aacbde69278a64899df44f65c21c2abb12764cc4ed8cc0d",
    }),
    "frozen/work.py": ("chip_smoke.py", {
        "PEAK_BYTES_S": "d2113792eec9aed27f61fa050f38259a9a3ccd188c42c1730bf83ccc7ad13d3f",
        "PEAK_OPS_S": "4c0cc912d67bb3bad2d4b102d9ed7e534479dec39a8d6085bc5fe910df4eb283",
        "bound": "bbad9859c72357f9be45f03974173ff45b6a61716379d40c1b4eb9affd7c30fa",
        "nbytes": "d90b080e69286328484246aa3a3346deac480b24332dba274e0b54c7dc6b2848",
        "match_work": "61a8a8279c9f0e8c22b1423917483a38746633d12e7d7a4856ecbe8df0ab4825",
    }),
    "reference/core/binio.py": ("tokenmonster_tpu_torch/core/binio.py", {
        "Reader.__init__": "7ee93fa9fa6b72f6f4407a5c90396a197621bf4881bb1cfd0f0eeabeae7d438a",
        "Reader.from_file": "e96cb9f1ee09543d653eba4a62c36f5482106f4673ebdb51aa0a7ce2e26af57a",
        "Reader._require": "781895eb5c78310b63fef119f25273d128fa99cd62173cb75f95a3610a655d9a",
        "Reader.read_byte": "0956a50660b8f82bb7184efd45ce1a6fbc6bf647af34f043c76454ac909a2090",
        "Reader.read_uint24": "4f93b86c085ebefbab25514112cf30474a3c670967f76119a0872531865baf56",
        "Reader.read_float32": "b2b3698a6d421a1d46a22739cd975ca543b30dd8d21e568791c1341c71fbc384",
        "Reader.read_bytes": "1e622db7cbba7859e505e50034097debf71e81dabfb9a0d0865edec22579633c",
        "Reader.read_bytes8": "2fd3abc5d92c02cedc5bc6c1b8449c0c24ca21b1c91056ba302fd20bf3f63370",
        "Reader.eof": "7d577e1b0430d09077440c3bbb8fbd9d00ed5024b6336064f68229868a6f885b",
    }),
    "reference/core/capcode.py": ("tokenmonster_tpu_torch/core/capcode.py", {
        "C_CHAR": "b1f37c919a29a545162eb367e41bc3f6ee12c9330f5beaa695d2c6cda53c1812",
        "C_WORD": "7a4584929a71b9c73cdfb0eb7acc5946eaaa130fe262c7c5bc5b1cde054fcdf5",
        "C_DELETE": "a7f76d0a463b8a48fd6394dc532aada5b9faf831cede688c23dd4980aff7e7db",
        "CHARACTER_TOKEN": "4221a1fbe6a7a7db047523cbdf69c21377228c7ef02f53833e20c4fb0078b9c9",
        "WORD_TOKEN": "e3f8896ccb101301cbdfe167d3b1571d6b7b569d1b2bab29cdb679dac7a4333b",
        "DELETE_TOKEN": "2d788a65e75df156574ce4e0be3b5f2a878f89d5daefd01dc28f1a667ad0345d",
        "NO_CAPCODE_DELETE_TOKEN": "78d6cbc77aac67931209cd26e5dd86d38a25f8a2e58ee9440595dab38321688a",
        "_APOS": "6b8fd5e2df6eac4a372ffd9df0752131a97f4c32208774d2d45511e108959382",
        "_APOS2": "44e73d5eb3973c0a5f1b0ce21b78851312c8cc0f23db41fda47eae09966eef84",
        "_is_letter_c": "963e5f6e25850f1a7363bbe40a9ba25c249b553cea20f92b302423825cd0f569",
        "_is_upper_c": "0cad27b6e87af1a801818ad7012cfcee88b6509795de9e20915ce813569ffe84",
        "_is_lower_c": "e4b5baaa78d606d39ed70fb3f9888bd832246243a743e1b537db4338525b83cb",
        "_is_number_c": "12bed67d4d596b7c4d884fb02e3572a3830dd4ccd9a93d2ab9ad8f655d531eb5",
        "_is_modifier_c": "922cd6f81dbb8f3c1a3d5ca04aebd2e4614f942b5aef2fabcc4755bd8e1758d4",
        "encode": ("e3218d4e7e4d33a067ad8c360bd428446a17f6e9af0e913854be7e07c3637bd0",
            "a3794ad6bcc2fe6d8768fa1a550e8a9b9b576cd572930831ee26cc7d0aad5364"),
        "no_capcode_encode": ("88cbb66191eda18db40c90b98deab2dec712a685a595b2b65a933dc14c5adf50",
            "939d84d93fa60acc13a91d881f7cc1f08a6c684de946fa4ae5e47539140a183d"),
    }),
    "reference/core/dictionary.py": ("tokenmonster_tpu_torch/core/dictionary.py", {
        "MAX_KEY_LEN": "4a0ac5203debe29c8b9699ecc1999d453b9d987d4b2ff53b1992eaa5520cbd73",
        "sort_key": "696772ed16720a0aa0bf66a947ab1d5ee8f210154dd2d36048fc7ac8533a289d",
        "Dictionary.__doc__": "e39f05778353315b195af0bafe63bd33adc32d72c1f79597593357ede3246e60",
        "Dictionary.__slots__": "b045d124178a363190c8faadc7338c998fc483b9c994ae1d67ac80e90ced02f4",
        "Dictionary.__init__": "a3fe0eeea30f4b7fe79271a75a30b193a322b8af391bd48662cc2a62df7bd18f",
        "Dictionary.add": "6fe926f68548d3933d75c139355efd16dce09ae8ee71dbf748178a4b1dbd36db",
        "Dictionary.build": "f55f1c46ca7999d3d2f16ff395ed28e1db5ee53d18ce80154a862716c168083f",
        "Dictionary.longest_substring": "5d543bf0902e83ad4d6d3d14e8ec8c780dce97a78a2d8cb866b08fe91203c239",
    }),
    "reference/core/normalize.py": ("tokenmonster_tpu_torch/core/normalize.py", {
        "NFD": "273dcdee135eb26619650cb955b8d9f26032ab78549d6219326b92b7ce69db22",
        "LOWERCASE": "0e4388528566a9d162963b343b887d76fe753b57c4a3b054488e884a0cd2f5c9",
        "ACCENTS": "7c9a855ed439065f4532d0d36e269d35881bd19ce0c5087617c100ec8cf413b2",
        "QUOTEMARKS": "47c1c213a43c3d82bd3fb3adbd1a138afb8e1327531e17a998ac75401be76008",
        "COLLAPSE": "19041e8490ee6dab8d76b764b2f4a2eae4d763e4ae10e864d68894a6876460f8",
        "TRIM": "452c6a60286eb391b4ffc31825e0385368ec549dadad9c25f121224d9b53bdd3",
        "LEADING_SPACE": "ae30afdce456522b006181192a44ced5a77b166a6fd0fdb162a407ea17f7cdd2",
        "UNIX_LINES": "22b9ce6abc663da4667a352d967eb6492dcea55e693c79082111f0af3f169f0c",
        "_NAME_TO_FLAG": "e5d068cfd354376e010702038e9c39ba3113d683b0571e2de311d988fa57ac0f",
        "parse_flags": "b4c696a3d12b4550f33065aa3a38e87d5a9d8a84b4b79377d8ef158ea44e0dd2",
        "_nfd": "967285fd93fd5dc57ac94885b1f2dcefd9458c84d52e1962b4b80e10a68c401c",
        "_lowercase": "2c275afef96ada41d805d7a48f7326d8ae07c2488087814de805a1af7095e883",
        "_strip_accents": "d3d89438af77628fa1b5192f7b00c05776ac95e38cc4adea76473fa568af66ab",
        "_unix_lines": "f4e39b85d467091c74b116013c12db19bbf1589a16db97f48ec152943316efe7",
        "_collapse": "91b9d79738853c08c818f06a03d2a232719c3a372e27ebd51cd19564d565b618",
        "_quotemarks": "58d69c36c84d05f7e4dd3fc1df48f41642ca8e6c2095e9834419d76462c86b21",
        "_trim": "2d293e6426607d50513850fdd2769a8915600714f34d8b8e42adb875c479b487",
        "_leading_space": "98a62bc4ef1cf5bfcd39f17559cf473940601f9315c3f3abf5e5724db7a6d6f1",
        "normalize": "7bc8c6a1ce329e3c3fd4d4608fb1359e848d402c7146210cc9102b2c5dfd8067",
        "Normalizer.__doc__": "c45e3b0be4de2d6246998306b2d8888c807ecf647e5d93cb3eec2e611780bc5f",
        "Normalizer.__slots__": "730f9d972022bced69557942685bffafbad7f2abef257dde45796c10da17a445",
        "Normalizer.__init__": "01f04fa143dc2d5f694674e7a27d0db70ead2083389cf56edf06f6fd215bd3fd",
        "Normalizer.normalize": "238cb320d41fb76bad6d7f1e3a21177d745ecfeb2b5ba545a804f47c0b70f95d",
    }),
    "reference/core/tokenmeta.py": ("tokenmonster_tpu_torch/core/tokenmeta.py", {
        "DOES_NOT_EXIST": "890ad80942303376719108702b5a79d7ab03bc8c8799dccc4ffcf75244ed9f9a",
    }),
    "reference/core/vocab.py": ("tokenmonster_tpu_torch/core/vocab.py", {
        "MAX_TOKEN_LEN": "6984b20d58639b1848fc1283ad8ad4443e8944b595eaceff28a7300b66658105",
        "apply_capcode": "6ab71dbc3371b53cdc9d000680015824c6e2640691ef11e7d4f6f792790928a1",
        "normalize_and_capcode": "516ebebfc4e0fdf7f015e5715a0aea2e7ad2dd1b55504cd96fc6457664b8fadc",
        "Vocab.__doc__": "f7ee606e38978fa7d9f3717ee57385c4e9e146953713a2ce1b3071ae46b15c67",
        "Vocab.__init__": "80e4418f5ce965e01fb9259e61111b6bef71f299c9da125fa8fc769c12adecf9",
        "Vocab.normalize": "28ea700ec9393c5fbee13113a4c1e15cb6a23c4de307c795bb60472999c1e9d0",
        "Vocab.load": "e5f5809d2b46e46803ab1ce47a311c515c4ca629c31e95d1fab4602926fd746f",
        "Vocab._load_reader": "96e67974371f800a6dce0e0f6770fd2f87623547ed114e04377632038e9a9921",
    }),
    "reference/utils/chartypes.py": ("tokenmonster_tpu_torch/utils/chartypes.py", {
        "MAX_CP": "af731c191279803b3d5da33116c2c97d0f7dc914ba6a554f2a027d1fe2ff5fa7",
        "LETTER": "9c81f53b27181a30b0525935a74f4bc94d3312311661839c5b5996b243865036",
        "UPPER": "89c82cd8304623292d7b9923f6923cd29f2783e6b6731517a49e5b0f628e24a8",
        "LOWER": "596821f2d26e32b4da9d89886c2c0e74379f28308d7c83a35f8e5fb4d55c4a63",
        "NUMBER": "22d6c9dc79744e5e4b9a44aa00b2f256c437989c84bc4c41ab638c3e65a16e84",
        "DIGIT": "b8e4e89a9b18d60212e2f1c9f7ce558a545aaa8dfbd2589d4d3189cf94a2ae55",
        "MODIFIER": "281dd46321a426db611f45e33f86bb430dcd837e4454b71ed6d76f85abd5ebef",
        "WHITESPACE": "7d3bbeb940b0a064341d2dadc9b57700e3c04d84a8d5904b1cc2074fc7ecf184",
        "MARK_MN": "41e4010f174614db562c42988bc034ef75fb3c765b9fe7334221bbbb30e23a1c",
        "_CACHE": "fdf59f28b5d0f3d4d683acf5273dd69f335df0b8d6acec979aeb3f518ab2c72d",
        "_WHITE_SPACE": "38a04bfe9bd8514517ec0d7f41ead4f95465fbb0fff627a516f042b44210d173",
        "_build": "09b73d0ba584a9a12e490753752a6590c0c556a25348261fe46de660ff347cd9",
        "_load": "b0cde63e720c9d40c09cd00915dab7cd1f0fea8b3d7c27f50a95e4be6ad51d89",
        "props_table": "88ff43e662733a8767a3b66cd39e5e40ec565b46b96427070c2ace1639594ccc",
        "lower_table": "1ec33bcc5b1e1a5840614b1e35b75e49df131a870cda797316e72e67b077e930",
        "is_letter": "db5dd06a621e3b7697f8f001f85fb01be7c3539362ed18cfb7c7e1486e5673c9",
        "is_upper": "e16385ec61116b5b872f856e7cf96c2295f5e6df665e122a809494a1a35d92dc",
        "is_lower": "ee7a9285f0470d2dfd4d418cfd97dc205bfec35d976c1be6220c198c3908911c",
        "is_number": "5fccfb4c2a1b9b1d70b3c7bf3b16bdbccadc0d4218f626ec0858d1c9f31a8a72",
        "is_modifier": "97fb8e5a25406842d192e1825fae50a8595cf7d5b15ba9f61089cd1603facd61",
        "to_lower": "6eb454a3ebd9e3ef1bfa5ee1e8852f3fa60acf015c04ed4d84fa0172551e924e",
    }),
}


def _lines(path: str):
    with open(path) as f:
        src = f.read()
    return src.splitlines(keepends=True), ast.parse(src)


def _names(node) -> list:
    if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    return []


def _docstring(node) -> bool:
    return (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str))


def pieces(path: str) -> dict:
    """{name or Class.member: (text, node)} of a module's pieces."""
    lines, tree = _lines(path)
    out = {}

    def text(node):
        first = min([d.lineno for d in getattr(node, "decorator_list", [])]
                    + [node.lineno])
        return "".join(lines[first - 1:node.end_lineno])

    for node in tree.body:
        for name in _names(node):
            out[name] = (text(node), node)
        if isinstance(node, ast.ClassDef):
            for k, member in enumerate(node.body):
                names = (["__doc__"] if k == 0 and _docstring(member)
                         else _names(member))
                for name in names:
                    out[f"{node.name}.{name}"] = (text(member), member)
    return out


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _without_native(node) -> str:
    """The function's syntax tree with any ``try`` block that imports
    ``native``, and its docstring, taken out."""
    node = ast.parse(ast.unparse(node)).body[0]
    node.body = [s for k, s in enumerate(node.body)
                 if not (k == 0 and _docstring(s))
                 and not (isinstance(s, ast.Try) and any(
                     isinstance(n, ast.ImportFrom)
                     and any(a.name == "native" for a in n.names)
                     for n in ast.walk(s)))]
    return ast.dump(node)


@pytest.mark.parametrize("copy", sorted(PIECES))
def test_copy_holds_its_pieces_as_they_were_at_the_commit(copy):
    source, want = PIECES[copy]
    got = pieces(os.path.join(BENCH, copy))
    with open(os.path.join(BENCH, copy)) as f:
        doc = f.read(600)
    assert source in doc and "6d463e6b506c" in doc, f"{copy} names no source"
    classes = {n.split(".")[0] for n in want if "." in n}
    top = {n for n in got if "." not in n}
    assert top == {n for n in want if "." not in n} | classes, \
        f"{copy} holds pieces it should not"
    for name, digest in want.items():
        copied = digest[1] if isinstance(digest, tuple) else digest
        assert _sha(got[name][0]) == copied, f"{copy}::{name}"


@pytest.mark.parametrize("copy", sorted(PIECES))
def test_pieces_derive_from_their_sources(copy):
    source, want = PIECES[copy]
    got = pieces(os.path.join(BENCH, copy))
    src = pieces(os.path.join(ROOT, source))
    for name, digest in want.items():
        at_commit = digest[0] if isinstance(digest, tuple) else digest
        if name not in src or _sha(src[name][0]) != at_commit:
            continue            # the source has moved on since the commit
        if isinstance(digest, tuple):
            assert _without_native(src[name][1]) == _without_native(
                got[name][1]), f"{copy}::{name}"
        else:
            assert got[name][0] == src[name][0], f"{copy}::{name}"
