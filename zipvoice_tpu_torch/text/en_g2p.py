"""Offline English G2P fallback (lexicon + letter-to-sound rules -> IPA).

The reference's EN path requires piper_phonemize / espeak-ng (ref
zipvoice/tokenizer/tokenizer.py:32-39, 321-329), neither of which is always
installed.  This module covers EN offline the way the vendored pinyin
table covers ZH: a deterministic, dependency-free
grapheme-to-phoneme system producing espeak-style en-us IPA over the SAME
token inventory as piper's phoneme-id map (text/espeak_map.py), so the
downstream token-stream shaping (``shape_espeak_clauses``) and id mapping
are identical to the real backend's.

It is NOT the espeak engine: pronunciations come from a built-in exception
lexicon of high-frequency words plus context-sensitive letter-to-sound
rules (authored for this module in the spirit of the classic NRL
text-to-phoneme rule sets).  Token goldens pinned from it are therefore
marked ``provenance: offline-fallback`` in the golden report; when a real
espeak backend is present it always wins (tokenizer.espeak_phonemize only
reaches this module when both piper and the binary are absent).

Output contract: one IPA string per clause, words separated by single
spaces, primary/secondary stress marks (ˈ/ˌ) inline, length mark ː —
exactly the surface ``shape_espeak_clauses`` consumes.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# exception lexicon: high-frequency words + words whose spelling defeats the
# rules.  espeak-style en-us IPA (ɹ for r, ɚ for unstressed r-colored schwa,
# oʊ/eɪ/aɪ/aʊ/ɔɪ diphthongs, ː on ɑ/ɔ/u/i when espeak lengthens them).
# ---------------------------------------------------------------------------

LEXICON: Dict[str, str] = {
    "a": "ɐ", "an": "ɐn", "the": "ðə",
    "i": "ˈaɪ", "you": "juː", "he": "hiː", "she": "ʃiː", "it": "ɪt",
    "we": "wiː", "they": "ðeɪ", "me": "miː", "him": "hɪm", "her": "hɜː",
    "us": "ˈʌs", "them": "ðɛm", "my": "maɪ", "your": "jɔːɹ", "his": "hɪz",
    "its": "ɪts", "our": "ˈaʊɚ", "their": "ðɛɹ", "this": "ðɪs",
    "that": "ðæt", "these": "ðiːz", "those": "ðoʊz", "who": "huː",
    "what": "wʌt", "which": "wɪtʃ", "where": "wɛɹ", "when": "wɛn",
    "why": "waɪ", "how": "haʊ",
    "is": "ɪz", "am": "æm", "are": "ɑːɹ", "was": "wʌz", "were": "wɜː",
    "be": "biː", "been": "bɪn", "being": "ˈbiːɪŋ",
    "have": "hæv", "has": "hɐz", "had": "hæd", "having": "ˈhævɪŋ",
    "do": "duː", "does": "dʌz", "did": "dɪd", "doing": "ˈduːɪŋ",
    "done": "dʌn",
    "will": "wɪl", "would": "wʊd", "can": "kæn", "could": "kʊd",
    "shall": "ʃæl", "should": "ʃʊd", "may": "meɪ", "might": "maɪt",
    "must": "mʌst", "ought": "ˈɔːt",
    "and": "ænd", "or": "ɔːɹ", "but": "bʌt", "if": "ɪf", "because": "bɪkˈʌz",
    "as": "æz", "of": "ʌv", "at": "æt", "by": "baɪ", "for": "fɔːɹ",
    "with": "wɪð", "about": "ɐbˈaʊt", "against": "ɐɡˈɛnst",
    "between": "bɪtwˈiːn", "into": "ˌɪntʊ", "through": "θɹuː",
    "during": "djˈʊɹɪŋ", "before": "bɪfˈoːɹ", "after": "ˈæftɚ",
    "above": "əbˈʌv", "below": "bɪlˈoʊ", "to": "tuː", "from": "fɹʌm",
    "up": "ˈʌp", "down": "daʊn", "in": "ɪn", "out": "ˈaʊt", "on": "ˈɑːn",
    "off": "ˈɔf", "over": "ˈoʊvɚ", "under": "ˈʌndɚ", "again": "ɐɡˈɛn",
    "further": "fˈɜːðɚ", "then": "ðɛn", "once": "wʌns", "here": "hɪɹ",
    "there": "ðɛɹ", "all": "ɔːl", "any": "ˈɛni", "both": "boʊθ",
    "each": "iːtʃ", "few": "fjuː", "more": "mɔːɹ", "most": "moʊst",
    "other": "ˈʌðɚ", "some": "sʌm", "such": "sʌtʃ", "no": "noʊ",
    "nor": "nɔːɹ", "not": "nɑːt", "only": "ˈoʊnli", "own": "ˈoʊn",
    "same": "seɪm", "so": "ˈsoʊ", "than": "ðɐn", "too": "tuː",
    "very": "ˈvɛɹi", "just": "dʒʌst", "now": "naʊ",
    "one": "wʌn", "two": "tuː", "three": "θɹiː", "four": "fɔːɹ",
    "five": "faɪv", "six": "sɪks", "seven": "ˈsɛvən", "eight": "eɪt",
    "nine": "naɪn", "ten": "tɛn", "eleven": "ɪlˈɛvən", "twelve": "twɛlv",
    "twenty": "twˈɛnti", "thirty": "θˈɜːɾi", "forty": "fˈɔːɹɾi",
    "fifty": "fˈɪfti", "hundred": "hˈʌndɹəd", "thousand": "θˈaʊzənd",
    "million": "mˈɪliən", "first": "fˈɜːst", "second": "sˈɛkənd",
    "third": "θˈɜːd",
    "yes": "jɛs", "people": "pˈiːpəl", "time": "taɪm", "year": "jɪɹ",
    "day": "deɪ", "way": "weɪ", "thing": "θɪŋ", "man": "mæn",
    "woman": "wˈʊmən", "world": "wɜːld", "life": "laɪf", "hand": "hænd",
    "part": "pɑːɹt", "child": "tʃaɪld", "children": "tʃˈɪldɹən",
    "eye": "aɪ", "place": "pleɪs", "work": "wɜːk", "week": "wiːk",
    "case": "keɪs", "point": "pɔɪnt", "government": "ɡˈʌvɚnmənt",
    "company": "kˈʌmpəni", "number": "nˈʌmbɚ", "group": "ɡɹuːp",
    "problem": "pɹˈɑːbləm", "fact": "fækt", "water": "wˈɔːɾɚ",
    "money": "mˈʌni", "month": "mʌnθ", "night": "naɪt", "area": "ˈɛɹiə",
    "story": "stˈoːɹi", "issue": "ˈɪʃuː", "side": "saɪd", "kind": "kaɪnd",
    "head": "hɛd", "house": "haʊs", "friend": "fɹɛnd", "father": "fˈɑːðɚ",
    "mother": "mˈʌðɚ", "hour": "ˈaʊɚ", "game": "ɡeɪm", "line": "laɪn",
    "end": "ˈɛnd", "member": "mˈɛmbɚ", "law": "lɔː", "car": "kɑːɹ",
    "city": "sˈɪɾi", "community": "kəmjˈuːnɪɾi", "name": "neɪm",
    "team": "tiːm", "minute": "mˈɪnɪt", "idea": "aɪdˈiə", "body": "bˈɑːdi",
    "information": "ˌɪnfɚmˈeɪʃən", "nothing": "nˈʌθɪŋ", "right": "ɹaɪt",
    "study": "stˈʌdi", "book": "bʊk", "job": "dʒɑːb", "word": "wɜːd",
    "business": "bˈɪznəs", "school": "skuːl", "student": "stˈuːdənt",
    "country": "kˈʌntɹi", "american": "ɐmˈɛɹɪkən", "state": "steɪt",
    "family": "fˈæmɪli", "president": "pɹˈɛzɪdənt", "question": "kwˈɛstʃən",
    "service": "sˈɜːvɪs", "music": "mjˈuːzɪk", "language": "lˈæŋɡwɪdʒ",
    "test": "tɛst", "hello": "həlˈoʊ", "hi": "haɪ", "goodbye": "ɡʊdbˈaɪ",
    "thanks": "θæŋks", "thank": "θæŋk", "please": "pliːz",
    "sorry": "sˈɑːɹi", "okay": "ˌoʊkˈeɪ", "today": "tədˈeɪ",
    "tomorrow": "təmˈɑːɹoʊ", "yesterday": "jˈɛstɚdeɪ", "morning": "mˈɔːɹnɪŋ",
    "evening": "ˈiːvnɪŋ", "fine": "faɪn", "good": "ɡʊd", "great": "ɡɹeɪt",
    "new": "nuː", "old": "oʊld", "high": "haɪ", "low": "loʊ",
    "little": "lˈɪɾəl", "long": "lɑːŋ", "big": "bɪɡ", "small": "smɔːl",
    "large": "lɑːɹdʒ", "young": "jʌŋ", "different": "dˈɪfɹənt",
    "important": "ɪmpˈoːɹtənt", "public": "pˈʌblɪk", "bad": "bæd",
    "able": "ˈeɪbəl", "early": "ˈɜːli", "last": "læst", "next": "nɛkst",
    "many": "mˈɛni", "much": "mʌtʃ", "even": "ˈiːvən", "also": "ˈɔːlsoʊ",
    "back": "bæk", "well": "wɛl", "still": "stɪl", "never": "nˈɛvɚ",
    "really": "ɹˈɪli", "always": "ˈɔːlweɪz", "often": "ˈɔfən",
    "together": "təɡˈɛðɚ", "say": "seɪ", "says": "sɛz", "said": "sɛd",
    "get": "ɡɛt", "got": "ɡɑːt", "make": "meɪk", "made": "meɪd",
    "go": "ɡoʊ", "went": "wɛnt", "gone": "ɡɔn", "know": "noʊ",
    "knew": "nuː", "known": "noʊn", "take": "teɪk", "took": "tʊk",
    "taken": "tˈeɪkən", "see": "siː", "saw": "sɔː", "seen": "siːn",
    "come": "kʌm", "came": "keɪm", "think": "θɪŋk", "thought": "θɔːt",
    "look": "lʊk", "want": "wɑːnt", "give": "ɡɪv", "gave": "ɡeɪv",
    "given": "ɡˈɪvən", "use": "juːz", "used": "juːzd", "find": "faɪnd",
    "found": "faʊnd", "tell": "tɛl", "told": "toʊld", "ask": "æsk",
    "seem": "siːm", "feel": "fiːl", "felt": "fɛlt", "try": "tɹaɪ",
    "leave": "liːv", "left": "lɛft", "call": "kɔːl", "turn": "tɜːn",
    "put": "pʊt", "mean": "miːn", "keep": "kiːp", "kept": "kɛpt",
    "let": "lɛt", "begin": "bɪɡˈɪn", "began": "bɪɡˈæn", "show": "ʃoʊ",
    "hear": "hɪɹ", "heard": "hɜːd", "play": "pleɪ", "run": "ɹʌn",
    "move": "muːv", "live": "lɪv", "believe": "bɪlˈiːv", "bring": "bɹɪŋ",
    "brought": "bɹɔːt", "happen": "hˈæpən", "write": "ɹaɪt",
    "wrote": "ɹoʊt", "written": "ɹˈɪʔn̩", "read": "ɹiːd", "sit": "sɪt",
    "stand": "stænd", "lose": "luːz", "lost": "lɔst", "pay": "peɪ",
    "meet": "miːt", "include": "ɪŋklˈuːd", "continue": "kəntˈɪnjuː",
    "learn": "lɜːn", "change": "tʃeɪndʒ", "lead": "liːd", "understand":
    "ˌʌndɚstˈænd", "watch": "wɑːtʃ", "follow": "fˈɑːloʊ", "stop": "stɑːp",
    "create": "kɹiːˈeɪt", "speak": "spiːk", "spoke": "spoʊk",
    "listen": "lˈɪsən", "love": "lʌv", "like": "laɪk", "need": "niːd",
    "become": "bɪkˈʌm", "mr": "mˈɪstɚ", "mrs": "mˈɪsɪz", "ms": "mɪz",
    "dr": "dˈɑːktɚ", "etc": "ɛtsˈɛtɹə",
    # words whose spelling badly defeats LTS rules
    "one's": "wʌnz", "i'm": "aɪm", "i've": "aɪv", "i'll": "aɪl",
    "i'd": "aɪd", "you're": "jʊɹ", "you've": "juːv", "you'll": "juːl",
    "he's": "hiːz", "she's": "ʃiːz", "it's": "ɪts", "we're": "wɪɹ",
    "we've": "wiːv", "they're": "ðɛɹ", "they've": "ðeɪv",
    "don't": "doʊnt", "doesn't": "dˈʌzənt", "didn't": "dˈɪdənt",
    "won't": "woʊnt", "can't": "kænt", "couldn't": "kˈʊdənt",
    "shouldn't": "ʃˈʊdənt", "wouldn't": "wˈʊdənt", "isn't": "ˈɪzənt",
    "aren't": "ˈɑːɹənt", "wasn't": "wˈʌzənt", "weren't": "wˈɜːənt",
    "haven't": "hˈævənt", "hasn't": "hˈæzənt", "that's": "ðæts",
    "there's": "ðɛɹz", "what's": "wʌts", "let's": "lɛts",
    "colonel": "kˈɜːnəl", "iron": "ˈaɪɚn", "island": "ˈaɪlənd",
    "answer": "ˈænsɚ", "often's": "ˈɔfənz", "women": "wˈɪmɪn",
    "busy": "bˈɪzi", "buy": "baɪ", "eyes": "aɪz", "heart": "hɑːɹt",
    "sure": "ʃʊɹ", "sugar": "ʃˈʊɡɚ", "says'": "sɛz",
    "soccer": "sˈɑːkɚ",  # hard-k exception to the soft cc-before-e rule
}

# ---------------------------------------------------------------------------
# letter-to-sound rules.  Each rule: (left-context, fragment, right-context,
# phonemes).  Contexts are small regex classes over the REMAINING letters:
#   '#'  one or more vowels         'V' exactly one vowel
#   'C'  exactly one consonant      ':' zero or more consonants
#   '$'  word edge                  ''  anything
# First matching rule at the current position wins (rules for a given first
# letter are tried in order); the cursor advances past the fragment.
# ---------------------------------------------------------------------------

_VOWELS = "aeiouy"


def _ctx_match(left: str, right: str, lctx: str, rctx: str) -> bool:
    def side(s: str, ctx: str, is_left: bool) -> bool:
        # evaluate context pattern outward from the fragment
        seq = ctx[::-1] if is_left else ctx
        pos = 0
        text = s[::-1] if is_left else s
        for ch in seq:
            if ch == "$":
                return pos >= len(text)
            if ch == "#":
                if pos >= len(text) or text[pos] not in _VOWELS:
                    return False
                while pos < len(text) and text[pos] in _VOWELS:
                    pos += 1
            elif ch == "V":
                if pos >= len(text) or text[pos] not in _VOWELS:
                    return False
                pos += 1
            elif ch == "C":
                if pos >= len(text) or text[pos] in _VOWELS or not text[pos].isalpha():
                    return False
                pos += 1
            elif ch == ":":
                while pos < len(text) and text[pos] not in _VOWELS and text[pos].isalpha():
                    pos += 1
            else:  # literal letter
                if pos >= len(text) or text[pos] != ch:
                    return False
                pos += 1
        return True

    return side(left, lctx, True) and side(right, rctx, False)


# fmt: off
RULES: Dict[str, List[Tuple[str, str, str, str]]] = {
    "a": [
        ("", "ation", "$", "eɪʃən"), ("", "able", "$", "əbəl"),
        ("$", "ab", "", "əb"),
        ("", "air", "", "ɛɹ"), ("", "ar", "$", "ɚ"), ("", "ar", "", "ɑːɹ"),
        ("", "augh", "", "ɔː"), ("", "au", "", "ɔː"), ("", "aw", "", "ɔː"),
        ("", "ay", "", "eɪ"), ("", "ai", "", "eɪ"),
        ("", "alk", "", "ɔːk"), ("", "all", "", "ɔːl"),
        ("", "a", "Ce$", "eɪ"),    # magic-e: late, came
        ("", "a", "C#", "ə" ),     # unstressed open: sofa-like interior
        ("", "a", "$", "ə"),
        ("", "a", "", "æ"),
    ],
    "b": [("", "bb", "", "b"), ("", "b", "$", "b"), ("", "b", "", "b")],
    "c": [
        ("", "ch", "", "tʃ"), ("", "ck", "", "k"),
        # soft double-c before e/i (success, accident); the context
        # language has no classes, so one rule per letter
        ("", "cc", "e", "ks"), ("", "cc", "i", "ks"),
        ("", "cc", "", "k"),
        ("", "c", "e", "s"), ("", "c", "i", "s"), ("", "c", "y", "s"),
        ("", "c", "", "k"),
    ],
    "d": [("", "dd", "", "d"), ("", "dge", "", "dʒ"), ("", "d", "", "d")],
    "e": [
        ("", "ee", "", "iː"), ("", "ea", "", "iː"),
        ("", "eigh", "", "eɪ"), ("", "ei", "", "iː"), ("", "ey", "$", "i"),
        ("", "ew", "", "uː"), ("", "er", "$", "ɚ"), ("", "er", "", "ɜː"),
        ("", "e", "$", ""),       # silent final e
        ("", "es", "$", "z"),     # plural/3sg after silent e
        ("", "ed", "$", "d"),     # past after silent e (approx)
        ("", "e", "", "ɛ"),
    ],
    "f": [("", "ff", "", "f"), ("", "f", "", "f")],
    "g": [
        ("", "gg", "", "ɡ"), ("", "gh", "$", ""), ("", "gh", "t", ""),
        ("", "gn", "$", "n"), ("$", "gn", "", "n"),
        ("", "g", "e$", "dʒ"), ("", "g", "i", "dʒ"), ("", "g", "y", "dʒ"),
        ("", "g", "e", "dʒ"),
        ("", "g", "", "ɡ"),
    ],
    "h": [("$", "h", "V", "h"), ("", "h", "", "")],
    "i": [
        ("", "igh", "", "aɪ"), ("", "ie", "$", "aɪ"), ("", "ie", "", "iː"),
        ("", "ing", "$", "ɪŋ"), ("", "ir", "", "ɜː"),
        ("", "ious", "$", "iəs"), ("", "ion", "$", "ən"),
        ("", "i", "Ce$", "aɪ"),   # magic-e: time, five
        ("", "i", "$", "i"),
        ("", "i", "", "ɪ"),
    ],
    "j": [("", "j", "", "dʒ")],
    "k": [("$", "kn", "", "n"), ("", "k", "", "k")],
    "l": [("", "ll", "", "l"), ("", "le", "$", "əl"), ("", "l", "", "l")],
    "m": [("", "mm", "", "m"), ("", "mb", "$", "m"), ("", "m", "", "m")],
    "n": [
        ("", "nn", "", "n"), ("", "ng", "$", "ŋ"), ("", "ng", "C", "ŋ"),
        ("", "n", "k", "ŋ"), ("", "n", "", "n"),
    ],
    "o": [
        ("", "ough", "$", "oʊ"), ("", "ought", "", "ɔːt"),
        ("", "oo", "k", "ʊ"), ("", "oo", "", "uː"),
        ("", "ow", "$", "oʊ"), ("", "ow", "", "aʊ"),
        ("", "ou", "s$", "əs"), ("", "ou", "", "aʊ"),
        ("", "oy", "", "ɔɪ"), ("", "oi", "", "ɔɪ"),
        ("", "or", "$", "ɔːɹ"), ("", "or", "", "ɔːɹ"),
        ("", "oa", "", "oʊ"),
        ("", "o", "Ce$", "oʊ"),   # magic-e: home, note
        ("", "o", "$", "oʊ"),
        ("", "o", "", "ɑː"),
    ],
    "p": [("", "pp", "", "p"), ("", "ph", "", "f"), ("", "p", "", "p")],
    "q": [("", "qu", "", "kw"), ("", "q", "", "k")],
    "r": [("", "rr", "", "ɹ"), ("", "r", "", "ɹ")],
    "s": [
        ("", "ss", "", "s"), ("", "sh", "", "ʃ"),
        ("", "sion", "$", "ʒən"), ("", "sure", "$", "ʒɚ"),
        ("V", "s", "$", "z"), ("", "s", "", "s"),
    ],
    "t": [
        ("", "tch", "", "tʃ"),
        ("", "tt", "", "t"), ("", "th", "", "θ"),
        ("", "tion", "$", "ʃən"), ("", "ture", "$", "tʃɚ"),
        ("", "t", "", "t"),
    ],
    "u": [
        ("", "ur", "", "ɜː"),
        ("", "u", "Ce$", "uː"),   # magic-e: tune, rule
        ("$", "u", "", "juː"),    # word-initial: unit, use
        ("", "u", "", "ʌ"),
    ],
    "v": [("", "v", "", "v")],
    "w": [("$", "wr", "", "ɹ"), ("", "wh", "", "w"), ("", "w", "", "w")],
    "x": [("$", "x", "", "z"), ("", "x", "", "ks")],
    "y": [
        ("$", "y", "", "j"),      # word-initial consonant y
        ("", "y", "$", "i"),      # final y: happy
        ("", "y", "", "ɪ"),
    ],
    "z": [("", "zz", "", "z"), ("", "z", "", "z")],
    "'": [("", "'s", "$", "z"), ("", "'", "", "")],
}
# fmt: on

_IPA_VOWEL_STARTS = set("aeiouæɑɒɔəɚɛɜɪʊʌʏø")


def _lts(word: str) -> str:
    """Letter-to-sound for an OOV word (lowercase letters + apostrophes)."""
    out: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        ch = word[i]
        rules = RULES.get(ch)
        if rules is None:  # digit or stray symbol survived normalization
            i += 1
            continue
        for lctx, frag, rctx, ph in rules:
            if not word.startswith(frag, i):
                continue
            if _ctx_match(word[:i], word[i + len(frag):], lctx, rctx):
                out.append(ph)
                i += len(frag)
                break
        else:
            i += 1  # unreachable: every table has a default rule
    ipa = "".join(out)
    # primary stress on the first vowel (crude but deterministic; real
    # stress assignment needs the espeak engine)
    for j, c in enumerate(ipa):
        if c in _IPA_VOWEL_STARTS:
            return ipa[:j] + "ˈ" + ipa[j:]
    return ipa


_WORD_RE = re.compile(r"[a-z']+")


def fallback_phonemize_clause(clause: str) -> str:
    """One normalized EN clause -> espeak-style IPA string (words separated
    by single spaces).  Assumes upstream normalization already expanded
    numbers/abbreviations (text/normalizer.py) — anything non-alphabetic
    left over is dropped like espeak drops unspoken symbols."""
    words = _WORD_RE.findall(clause.lower())
    ipas = []
    for w in words:
        entry = LEXICON.get(w)
        if entry is None and w.endswith("'s") and w[:-2] in LEXICON:
            base = LEXICON[w[:-2]]
            suffix = "ɪz" if base and base[-1] in "szʃʒ" else (
                "s" if base and base[-1] in "ptkfθ" else "z")
            entry = base + suffix
        if entry is None and w.endswith("s") and w[:-1] in LEXICON:
            base = LEXICON[w[:-1]]
            suffix = "ɪz" if base and base[-1] in "szʃʒ" else (
                "s" if base and base[-1] in "ptkfθ" else "z")
            entry = base + suffix
        ipas.append(entry if entry is not None else _lts(w))
    return " ".join(p for p in ipas if p)


def fallback_phonemize(text: str) -> List[str]:
    """Full piper-token-stream shaping, mirroring the subprocess backend
    (tokenizer._espeak_binary_phonemize): split on clause punctuation,
    phonemize each clause, reshape through shape_espeak_clauses."""
    from zipvoice_tpu_torch.text.tokenizer import _CLAUSE_SPLIT, shape_espeak_clauses

    parts = _CLAUSE_SPLIT.split(text)
    clauses = parts[::2]
    puncts = parts[1::2]
    ipas = [
        fallback_phonemize_clause(c) if c.strip() else "" for c in clauses
    ]
    return shape_espeak_clauses(ipas, puncts)
